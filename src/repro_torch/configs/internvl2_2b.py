"""internvl2-2b [vlm] — InternViT frontend + InternLM2 backbone
(arXiv:2404.16821; hf).  Backbone only per the assignment: 24L d_model=2048
16H (GQA kv=8) d_ff=8192 vocab=92553; the ViT is a stub supplying 256
precomputed patch embeddings as the sequence prefix.  vocab 92553 is padded
to the TP degree by the builder (92560 at tp=16)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    head_dim=128,
    frontend="vit",
    frontend_len=256,
)
