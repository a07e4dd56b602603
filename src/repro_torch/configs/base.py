"""Model & shape configuration dataclasses (a copy of the JAX package's).

Every assigned architecture is expressed as one :class:`ModelConfig`; the
four assigned input shapes are :class:`ShapeConfig` instances.  Reduced
("smoke") variants are derived mechanically so per-arch CPU tests exercise
the exact same code paths as the full dry-run configs.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

import torch


def padded_size(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= n."""
    if multiple <= 0:
        raise ValueError("multiple must be positive")
    return ((n + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) column of the assignment table."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long

    @property
    def tokens_per_step(self) -> int:
        if self.kind in ("train", "prefill"):
            return self.seq_len * self.global_batch
        return self.global_batch  # one new token per sequence


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "long")
ALL_SHAPES: tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def _port_field(default):
    """A field the JAX package's ``ModelConfig`` lacks: left out of the repr
    (and so of a checkpoint's ``config_hash``, shared by both packages)
    while it holds its default, which is the JAX package's behaviour."""
    return field(default=default, metadata={"port_only": True})


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # Layer pattern: one *period*, cycled over num_layers (remainder = prefix).
    #   "attn"   full causal attention block
    #   "local"  sliding-window attention block (window_size)
    #   "moe"    attention + mixture-of-experts FFN
    #   "rec"    RG-LRU recurrent block (Griffin)
    #   "mlstm"/"slstm"  xLSTM blocks
    #   "mla"/"mla_moe"  latent attention (MLA) + SwiGLU MLP / MoE FFN
    layer_pattern: tuple[str, ...] = ("attn",)
    window_size: int = 0
    # Leading layers before the cycled pattern (DeepSeek's dense first layer).
    layer_prefix: tuple[str, ...] = _port_field(())

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # "onehot": GShard-literal [T*k, E] cumsum dispatch (baseline);
    # "sort": O(T*k) stable-argsort dispatch, identical assignment (perf);
    # "dropless": every slot computed, no capacity (grouped expert products).
    moe_dispatch: str = "onehot"
    norm_topk_prob: bool = _port_field(True)  # renormalise the k picked probabilities

    # Multi-head latent attention (DeepSeek-V2): a kv_lora_rank-wide latent
    # and one qk_rope_head_dim-wide RoPE key shared by every head are cached;
    # per-head keys (nope | rope) and values are expanded from the latent.
    kv_lora_rank: int = _port_field(0)
    qk_nope_head_dim: int = _port_field(0)
    qk_rope_head_dim: int = _port_field(0)
    v_head_dim: int = _port_field(0)

    # Recurrent (Griffin RG-LRU)
    rnn_width: int = 0
    conv1d_width: int = 4

    # Encoder-decoder (audio family)
    encoder_layers: int = 0  # >0 => enc-dec; num_layers == decoder layers

    # Modality frontend stub: "vit" | "audio" | None.  Frontend embeddings
    # are *inputs* (precomputed), occupying the first frontend_len positions.
    frontend: str | None = None
    frontend_len: int = 0

    # Misc architectural knobs
    rope_theta: float = 10000.0
    # The published ``rope_scaling`` of a YaRN model ({"type": "yarn",
    # "factor", "original_max_position_embeddings", "beta_fast", "beta_slow",
    # "mscale", "mscale_all_dim"}); None: plain RoPE.
    rope_scaling: dict | None = _port_field(None)
    scale_embeddings: bool = _port_field(True)  # the embedding times sqrt(d_model)
    use_qk_norm: bool = False
    logit_softcap: float = 0.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # Compute policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_q_chunk: int = 512  # blockwise-attention q-chunk (memory bound)
    loss_seq_chunk: int = 512  # chunked cross-entropy block
    remat: bool = True
    scan_layers: bool = True  # scan over layer periods (False: unrolled probe)
    # Unroll inner lax.scans (attention chunks, CE chunks, mLSTM chunks) so
    # XLA cost_analysis counts every iteration — roofline probes only.
    unroll_scans: bool = False
    # Explicit sharding constraints on attention q/out activations (True) or
    # let GSPMD propagate head sharding from the weights alone (False).
    constrain_attn: bool = True
    # Remat policy: "nothing" (recompute all; lowest memory — the default:
    # "dots" saves every projection/FFN output and blows HBM at these batch
    # sizes) or "dots" (hillclimb option trading memory for collectives).
    remat_policy: str = "nothing"

    # Which shapes are supported (long_500k only for sub-quadratic archs).
    supports_long_context: bool = False
    has_decoder: bool = True

    def __repr__(self) -> str:
        shown = (f for f in fields(self) if not (
            f.metadata.get("port_only") and getattr(self, f.name) == f.default))
        return f"ModelConfig({', '.join(f'{f.name}={getattr(self, f.name)!r}' for f in shown)})"

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads != 0 and self.num_kv_heads > 0:
            raise ValueError(
                f"{self.name}: num_heads {self.num_heads} not a multiple of "
                f"num_kv_heads {self.num_kv_heads}"
            )

    # -- derived -------------------------------------------------------------

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def padded_heads(self, tp: int) -> int:
        """Q heads padded to the TP degree (zero extra output columns)."""
        if tp <= 1 or self.num_heads % tp == 0:
            return self.num_heads
        return padded_size(self.num_heads, tp)

    def padded_kv_heads(self, tp: int) -> int:
        # KV heads are never padded: KV projections are cheap; when kv %% tp
        # != 0 the sharding rules fall back to sequence-sharding the cache.
        return self.num_kv_heads

    def padded_vocab(self, tp: int) -> int:
        return padded_size(self.vocab_size, max(tp, 1))

    @property
    def pattern_for_layers(self) -> tuple[str, ...]:
        """The full per-layer kind list: ``layer_prefix``, then the period
        cycled over the remaining layers (its remainder a prefix of it)."""
        p, lead = self.layer_pattern, self.layer_prefix
        return lead + tuple(p[i % len(p)] for i in range(self.num_layers - len(lead)))

    def layer_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for k in self.pattern_for_layers:
            counts[k] = counts.get(k, 0) + 1
        return counts

    def shapes(self) -> tuple[ShapeConfig, ...]:
        """The assigned shapes this arch runs (skips recorded in DESIGN.md)."""
        out = [TRAIN_4K, PREFILL_32K]
        if self.has_decoder:
            out.append(DECODE_32K)
            if self.supports_long_context:
                out.append(LONG_500K)
        return tuple(out)

    def skipped_shapes(self) -> tuple[tuple[str, str], ...]:
        skips = []
        if not self.has_decoder:
            skips.append(("decode_32k", "encoder-only architecture"))
            skips.append(("long_500k", "encoder-only architecture"))
        elif not self.supports_long_context:
            skips.append(
                (
                    "long_500k",
                    "pure full-attention arch: 512k dense KV decode skipped "
                    "per assignment; sub-quadratic archs run it",
                )
            )
        return tuple(skips)

    # -- reduced config for CPU smoke tests ----------------------------------

    def smoke(self) -> "ModelConfig":
        period = len(self.layer_pattern)
        n_layers = max(2, min(period + 1, 4)) if period > 1 else 2
        mla = {}
        if self.kv_lora_rank:
            mla = dict(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                       v_head_dim=16)
        return replace(
            self,
            name=f"{self.name}-smoke",
            num_layers=len(self.layer_prefix) + n_layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            d_ff=128 if self.d_ff else 0,
            head_dim=16,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            rnn_width=64 if self.rnn_width else 0,
            window_size=min(self.window_size, 32) if self.window_size else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_len=8 if self.frontend_len else 0,
            attn_q_chunk=16,
            loss_seq_chunk=16,
            # droppless MoE at smoke scale: decode batches are tiny, and the
            # exactness tests compare decode vs full forward.
            capacity_factor=float(max(self.num_experts, 4)),
            **mla,
        )


def bytes_of(dtype_name: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype_name)).element_size()
