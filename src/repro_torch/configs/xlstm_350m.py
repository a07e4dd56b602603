"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517; unverified).
24L d_model=1024 4H d_ff=0 (blocks carry their own projections)
vocab=50304.  Ratio 3 mLSTM : 1 sLSTM per period.  Recurrent state is O(1)
in sequence length, so xlstm runs long_500k."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    supports_long_context=True,
)
