"""gemma3-4b [dense] — 5:1 local:global attention, 128k context
(hf:google/gemma-3-1b-pt family; unverified).  34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144.  head_dim=256 (decoupled from d_model/H, as in the
official config).  The 5-of-6 sliding-window layers make decode state O(1)
for most of the stack, so gemma3 runs long_500k (global layers keep the full
cache, sharded over the mesh)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window_size=1024,
    use_qk_norm=True,
    supports_long_context=True,
)
