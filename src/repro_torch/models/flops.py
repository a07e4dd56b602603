"""Analytic FLOP/byte accounting per (architecture x input shape).

Used by the roofline pipeline as the MODEL_FLOPS term (useful compute) and as
a cross-check on the HLO-derived totals:

    ratio = MODEL_FLOPS / HLO_FLOPS

catches remat recompute, head/vocab padding waste and redundant (replicated)
compute.  Conventions:

* matmul [m,k]x[k,n] = 2*m*k*n FLOPs;
* causal attention halves the score/PV terms;
* backward pass = 2x forward (train kind => total 3x forward);
* MODEL_FLOPS follows the 6*N*D rule (N = *active, unpadded* parameters
  excluding embeddings; D = tokens) for train, 2*N*D for inference.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.lm import head_plan


@dataclass
class FlopsReport:
    forward: float  # per-step forward FLOPs (global, padded/as-compiled)
    total: float  # incl. backward for train
    model_flops: float  # 6*N_active*D (train) / 2*N_active*D (inference)
    params_total: int
    params_active: int
    by_component: dict

    def summary(self) -> str:
        parts = ", ".join(f"{k}={v:.3e}" for k, v in self.by_component.items())
        return (
            f"total={self.total:.4e} fwd={self.forward:.4e} "
            f"model={self.model_flops:.4e} ({parts})"
        )


def _attn_layer_flops(cfg: ModelConfig, B: int, S: int, ctx: int, tp: int,
                      causal: bool = True) -> float:
    """One attention block forward (padded heads — as compiled)."""
    hp = head_plan(cfg, tp)
    Hp, Kp, hd, D = hp["Hp"], hp["Kp"], cfg.head_dim, cfg.d_model
    proj = 2 * B * S * D * (Hp + 2 * Kp) * hd + 2 * B * S * Hp * hd * D
    score_ctx = ctx / 2 if (causal and ctx == S) else ctx
    scores = 2 * B * S * score_ctx * Hp * hd
    pv = 2 * B * S * score_ctx * Hp * hd
    return proj + scores + pv


def _mlp_flops(cfg: ModelConfig, B: int, S: int) -> float:
    return 6 * B * S * cfg.d_model * cfg.d_ff if cfg.d_ff else 0.0


def _moe_layer_flops(cfg: ModelConfig, B: int, S: int, tp: int) -> float:
    T = B * S
    router = 2 * T * cfg.d_model * cfg.num_experts
    expert_tokens = T * cfg.experts_per_token
    experts = 6 * expert_tokens * cfg.d_model * cfg.moe_d_ff
    shared = 6 * T * cfg.d_model * cfg.moe_d_ff if cfg.num_shared_experts else 0
    return router + experts + shared


def _rec_layer_flops(cfg: ModelConfig, B: int, S: int) -> float:
    W = cfg.rnn_width or cfg.d_model
    proj = 2 * B * S * cfg.d_model * W * 3  # two in-branches + out
    conv = 2 * B * S * cfg.conv1d_width * W
    gates = 12 * B * S * W  # elementwise recurrence
    return proj + conv + gates


def _mlstm_layer_flops(cfg: ModelConfig, B: int, S: int, chunk: int = 64) -> float:
    W = cfg.num_heads * cfg.head_dim
    hd = cfg.head_dim
    up = 2 * B * S * cfg.d_model * 2 * W
    qkv = 3 * 2 * B * S * W * W
    core_intra = 2 * 2 * B * S * min(chunk, S) * cfg.num_heads * hd
    core_state = 2 * 2 * B * S * cfg.num_heads * hd * hd / max(chunk, 1)
    down = 2 * B * S * W * cfg.d_model
    return up + qkv + core_intra + core_state + down


def _slstm_layer_flops(cfg: ModelConfig, B: int, S: int) -> float:
    W = cfg.num_heads * cfg.head_dim
    hd = cfg.head_dim
    inp = 2 * B * S * cfg.d_model * 4 * W
    recur = 4 * 2 * B * S * cfg.num_heads * hd * hd
    down = 2 * B * S * W * cfg.d_model
    return inp + recur + down


def _layer_flops(cfg: ModelConfig, kind: str, B: int, S: int, ctx: int,
                 tp: int) -> float:
    if kind in ("attn", "global"):
        return _attn_layer_flops(cfg, B, S, ctx, tp) + _mlp_flops(cfg, B, S)
    if kind == "local":
        w_ctx = min(cfg.window_size, ctx)
        return _attn_layer_flops(cfg, B, S, w_ctx, tp, causal=False) + \
            _mlp_flops(cfg, B, S)
    if kind == "moe":
        return _attn_layer_flops(cfg, B, S, ctx, tp) + _moe_layer_flops(cfg, B, S, tp)
    if kind == "rec":
        return _rec_layer_flops(cfg, B, S)
    if kind == "mlstm":
        return _mlstm_layer_flops(cfg, B, S)
    if kind == "slstm":
        return _slstm_layer_flops(cfg, B, S)
    raise ValueError(kind)


def param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) *unpadded* non-embedding parameter counts."""
    D, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    total = active = 0

    def attn_params() -> int:
        return D * (H + 2 * KV) * hd + H * hd * D

    mlp = 3 * D * cfg.d_ff if cfg.d_ff else 0
    for kind in cfg.pattern_for_layers:
        if kind in ("attn", "local", "global"):
            p = attn_params() + mlp
            total += p
            active += p
        elif kind == "moe":
            a = attn_params()
            router = D * cfg.num_experts
            experts = cfg.num_experts * 3 * D * cfg.moe_d_ff
            shared = (3 * D * cfg.moe_d_ff) if cfg.num_shared_experts else 0
            total += a + router + experts + shared
            active += a + router + cfg.experts_per_token * 3 * D * cfg.moe_d_ff + shared
        elif kind == "rec":
            W = cfg.rnn_width or D
            p = 3 * D * W + cfg.conv1d_width * W + 5 * W + mlp
            total += p
            active += p
        elif kind == "mlstm":
            W = H * hd
            p = 2 * D * W + 3 * W * W + W * 2 * H + W * D
            total += p
            active += p
        elif kind == "slstm":
            W = H * hd
            p = 4 * D * W + 4 * H * hd * hd + W * D
            total += p
            active += p
    if cfg.encoder_layers:
        enc = cfg.encoder_layers * (attn_params() + mlp)
        dec_cross = cfg.num_layers * attn_params()  # cross-attention extra
        total += enc + dec_cross
        active += enc + dec_cross
    return total, active


def step_flops(cfg: ModelConfig, shape: ShapeConfig, tp: int = 1) -> FlopsReport:
    B = shape.global_batch
    comp: dict[str, float] = {}
    Vp = cfg.padded_vocab(tp)

    if shape.kind in ("train", "prefill"):
        S, ctx = shape.seq_len, shape.seq_len
        tokens = B * S
    elif shape.kind in ("decode", "long"):
        S, ctx = 1, shape.seq_len
        tokens = B
    else:
        raise ValueError(shape.kind)

    body = 0.0
    for kind in cfg.pattern_for_layers:
        body += _layer_flops(cfg, kind, B, S, ctx, tp)
    comp["body"] = body
    if cfg.encoder_layers:
        # encoder runs the full source sequence even in decode shapes (once;
        # amortised — we charge it only on train/prefill).
        if shape.kind in ("train", "prefill"):
            enc = cfg.encoder_layers * (
                _attn_layer_flops(cfg, B, S, ctx, tp, causal=False)
                + _mlp_flops(cfg, B, S)
            )
            cross = cfg.num_layers * _attn_layer_flops(cfg, B, S, ctx, tp,
                                                       causal=False)
        else:
            enc = 0.0
            cross = cfg.num_layers * _attn_layer_flops(
                cfg, B, 1, min(ctx, 4096), tp, causal=False)
        comp["encoder"] = enc
        comp["cross"] = cross
        body += enc + cross
    head = 2 * B * S * cfg.d_model * Vp
    comp["lm_head"] = head
    fwd = body + head

    if shape.kind == "train":
        total = 3.0 * fwd
    else:
        total = fwd

    n_total, n_active = param_counts(cfg)
    if shape.kind == "train":
        model = 6.0 * n_active * tokens
    else:
        model = 2.0 * n_active * tokens
        if shape.kind in ("decode", "long"):
            # decode also reads the KV cache: attention context work is real
            # useful work not captured by 2*N*D; add the score/PV terms.
            hp_ctx = 0.0
            for kind in cfg.pattern_for_layers:
                if kind in ("attn", "global", "moe"):
                    hp_ctx += 4 * B * ctx * cfg.num_heads * cfg.head_dim
                elif kind == "local":
                    hp_ctx += 4 * B * min(cfg.window_size, ctx) * \
                        cfg.num_heads * cfg.head_dim
            model += hp_ctx

    return FlopsReport(
        forward=fwd,
        total=total,
        model_flops=model,
        params_total=n_total,
        params_active=n_active,
        by_component=comp,
    )
