"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 attention:recurrent
(Griffin, arXiv:2402.19427; hf).  26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000.  Sub-quadratic (recurrent state + 2048-token window), so it
runs the long_500k shape."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=("rec", "rec", "local"),
    window_size=2048,
    rnn_width=2560,
    conv1d_width=4,
    logit_softcap=30.0,
    supports_long_context=True,
)
