"""The yardstick's arithmetic: peaks of the card, model FLOPs and the
least time of a flash-attention call.

Frozen here so that a change to the program cannot move it.  The FLOP
conventions are those of the port's ``models/flops.py``: a product
[m, k] x [k, n] is 2 m k n FLOPs, causal attention counts the (query, key)
pairs it sees, a training step is three forward passes.  The kernels'
bounds are ``chip_smoke.py``'s ``bound_ms``: each input read once and each
output written once at the HBM bandwidth, the products at the bf16
tensor-core peak, the larger of the two.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def visible_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal, optionally windowed, prompt of ``s``
    tokens attends."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attn_params(cfg: dict) -> int:
    d, hd = cfg["d_model"], cfg["head_dim"]
    return d * (cfg["num_heads"] + 2 * cfg["num_kv_heads"]) * hd \
        + cfg["num_heads"] * hd * d


def layer_active_params(cfg: dict) -> int:
    """Parameters one token's forward multiplies through in one block: the
    attention projections and either the SwiGLU MLP or the router and the
    ``experts_per_token`` experts it picks."""
    d = cfg["d_model"]
    if cfg.get("num_experts", 0):
        ffn = d * cfg["num_experts"] \
            + cfg["experts_per_token"] * 3 * d * cfg["moe_d_ff"]
    else:
        ffn = 3 * d * cfg["d_ff"]
    return attn_params(cfg) + ffn


def body_active_params(cfg: dict) -> int:
    return cfg["num_layers"] * layer_active_params(cfg)


def head_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def causal_attention_flops(cfg: dict, s: int) -> int:
    """Forward score and P.V products of a causal prompt of ``s`` tokens,
    over every layer: 2 products of 2 hd FLOPs a visible pair a head."""
    return cfg["num_layers"] * 4 * cfg["num_heads"] * cfg["head_dim"] \
        * visible_pairs(s)


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N tokens with N the active
    parameters of the blocks and the LM head, plus the causal attention's
    products three times (forward and backward)."""
    n = body_active_params(cfg) + head_params(cfg)
    return 6.0 * n * batch * seq + 3.0 * batch * causal_attention_flops(cfg, seq)


def prefill_flops(cfg: dict, prompt: int) -> float:
    """A prompt's forward through the blocks and the head on its last
    position (the engine's prefill), with its causal attention."""
    return 2.0 * body_active_params(cfg) * prompt + 2.0 * head_params(cfg) \
        + causal_attention_flops(cfg, prompt)


def decode_flops(cfg: dict, tokens: int, context_sum: int) -> float:
    """``tokens`` generated tokens, one a slot: the blocks and the head for
    each, and each new query's products against its cached keys (their
    number summed over the slots: ``context_sum``) in every layer."""
    return 2.0 * (body_active_params(cfg) + head_params(cfg)) * tokens \
        + cfg["num_layers"] * 4.0 * cfg["num_heads"] * cfg["head_dim"] * context_sum


def flash_forward_bound_s(b: int, h: int, kv: int, s: int, d: int) -> float:
    """Least time of one causal flash forward call [b, h, s, d] over ``kv``
    key heads, bf16: q, k, v read and out written once; 4 d FLOPs a
    visible pair a head."""
    ops = 4 * b * h * d * visible_pairs(s) / PEAK_BF16_FLOPS
    nbytes = 2 * b * d * (2 * h * s + 2 * kv * s) / HBM_BYTES_PER_S
    return max(ops, nbytes)


def flash_backward_bound_s(b: int, h: int, kv: int, s: int, d: int) -> float:
    """Least time of one causal flash backward call: five products of 2 d
    FLOPs a visible pair a head; q, k, v, out, d_out and the f32 lse read,
    dq, dk, dv written once."""
    ops = 10 * b * h * d * visible_pairs(s) / PEAK_BF16_FLOPS
    nbytes = (2 * b * d * (4 * h * s + 4 * kv * s) + 4 * b * h * s) \
        / HBM_BYTES_PER_S
    return max(ops, nbytes)
