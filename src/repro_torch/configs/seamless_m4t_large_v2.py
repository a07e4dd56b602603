"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal
(arXiv:2308.11596; hf).  Backbone only: 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 (padded to 256208 at tp=16).
The speech frontend is a stub supplying precomputed frame embeddings to the
encoder.  Decode shapes exercise the decoder (self-cache + static cross-KV);
long_500k is skipped (full-attention decoder)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    encoder_layers=24,
    frontend="audio",
)
