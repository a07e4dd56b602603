"""deepseek-v2-lite [mla] — latent attention + 64 routed experts top-6 and 2
shared (arXiv:2405.04434; huggingface.co/deepseek-ai/DeepSeek-V2-Lite).
27L d_model=2048 16H, kv_lora_rank=512 (no q latent), qk 128 + 64 RoPE,
v 128; YaRN x40 over 4096; layer 0 dense SwiGLU 10944, layers 1-26 MoE of
width 1408 with un-renormalised softmax weights; vocab 102400, untied head,
no embedding scale.  15.7 B parameters, 2.4 B active a token."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="mla",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    head_dim=192,
    layer_prefix=("mla",),
    layer_pattern=("mla_moe",),
    num_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    num_shared_experts=2,
    moe_dispatch="dropless",
    norm_topk_prob=False,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
    rope_scaling={"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                  "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                  "mscale_all_dim": 0.707},
    scale_embeddings=False,
    norm_eps=1e-6,
)
