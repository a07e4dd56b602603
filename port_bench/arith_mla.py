"""The yardstick's arithmetic for latent attention (the ``mla`` family):
model FLOPs of a served window and the least time of a prefill's flash
call, from the configuration's published widths.

The conventions are ``arith``'s: a product [m, k] x [k, n] is 2 m k n
FLOPs; a token's forward multiplies through the active parameters (every
projection of the latent attention, the leading dense layers' SwiGLU, in
the MoE layers the router, the ``experts_per_token`` routed experts and
the shared experts); the head runs on a prefill's last position and on
every decoded token.  Attention counts what each path computes:

* prefill (un-absorbed): per head the score over the query/key width
  (no-RoPE + RoPE) and P.V over the value width, 2 H (dqk + dv) FLOPs a
  causally visible (query, key) pair a layer;
* decode (absorbed): per head the score over the latent and the RoPE key
  and P.latent over the latent, 2 H (latent + rope + latent) FLOPs a cached
  position a layer (the two up-projections are active parameters).

A flash call's least time is ``arith``'s: its inputs q, k (H heads of
dqk) and v (H of dv) read and its output (H of dv) written once in bf16 at
the HBM bandwidth, or its products at the bf16 peak, the larger, at the
call's true widths whatever padding the program adds.
"""

from __future__ import annotations

from port_bench.arith import HBM_BYTES_PER_S, PEAK_BF16_FLOPS, visible_pairs


def _widths(cfg: dict) -> tuple[int, int, int, int, int, int]:
    return (cfg["d_model"], cfg["num_heads"], cfg["kv_lora_rank"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def attention_params(cfg: dict) -> int:
    """wq, wkv_a (latent and RoPE key), wkv_b (each head's no-RoPE key and
    value), wo."""
    d, h, r, dn, dr, dv = _widths(cfg)
    return d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d


def ffn_active_params(cfg: dict, kind: str) -> int:
    d = cfg["d_model"]
    if kind == "mla_moe":
        return d * cfg["num_experts"] \
            + (cfg["experts_per_token"] + cfg["num_shared_experts"]) * 3 * d * cfg["moe_d_ff"]
    return 3 * d * cfg["d_ff"]


def layer_kinds(cfg: dict) -> list[str]:
    lead, period = list(cfg["layer_prefix"]), list(cfg["layer_pattern"])
    return lead + [period[i % len(period)] for i in range(cfg["num_layers"] - len(lead))]


def body_active_params(cfg: dict) -> int:
    return sum(attention_params(cfg) + ffn_active_params(cfg, k) for k in layer_kinds(cfg))


def head_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, prompt: int) -> float:
    """A prompt through the blocks, the head on its last position, and its
    causal un-absorbed attention."""
    _d, h, _r, dn, dr, dv = _widths(cfg)
    return 2.0 * body_active_params(cfg) * prompt + 2.0 * head_params(cfg) \
        + cfg["num_layers"] * 2.0 * h * (dn + dr + dv) * visible_pairs(prompt)


def decode_flops(cfg: dict, tokens: int, context_sum: int) -> float:
    """``tokens`` decoded tokens through the blocks and the head, and the
    absorbed attention over ``context_sum`` cached positions (summed over
    the slots) in every layer."""
    _d, h, r, _dn, dr, _dv = _widths(cfg)
    return 2.0 * (body_active_params(cfg) + head_params(cfg)) * tokens \
        + cfg["num_layers"] * 2.0 * h * (2 * r + dr) * context_sum


def flash_forward_bound_s(cfg: dict, prompt: int) -> float:
    """Least time of one layer's causal un-absorbed attention over a prompt
    of ``prompt`` tokens, bf16, at its true widths."""
    _d, h, _r, dn, dr, dv = _widths(cfg)
    ops = 2 * h * (dn + dr + dv) * visible_pairs(prompt) / PEAK_BF16_FLOPS
    nbytes = 2 * h * prompt * (2 * (dn + dr) + 2 * dv) / HBM_BYTES_PER_S
    return max(ops, nbytes)
