"""llama4-maverick-400b-a17b [moe] — MoE 128 experts top-1 + shared expert,
early fusion (hf:meta-llama/Llama-4 family; unverified).  48L d_model=5120
40H (GQA kv=8) d_ff=8192 vocab=202048.  Maverick interleaves dense and
MoE layers (1:1), which with 128 routed experts lands at the nominal ~400B
total / ~17B active.  Head plan: 40 q heads / g=5 breaks
16-way grouping padding, so attention uses the expanded-KV path (Hp=48)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    layer_pattern=("attn", "moe"),
    num_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    num_shared_experts=1,
    rope_theta=500000.0,
)
