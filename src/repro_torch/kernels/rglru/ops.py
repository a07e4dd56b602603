"""Public RG-LRU scan entry point: the tensors' device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or raises.  Nothing falls back from one to the other.  The kernel
masks a ragged W itself, so no padding is needed (the JAX package's
``ops.rglru_scan`` pads W to its 128-lane blocks).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru.kernel import rglru_scan_cuda
from repro_torch.kernels.rglru.ref import rglru_scan_reference


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None):
    """a, b: [B, S, W]; h0: [B, W] or None.  Returns (h [B, S, W] in
    ``a.dtype``, h_last [B, W] in float32)."""
    tensors = (a, b) if h0 is None else (a, b, h0)
    if all(t.device.type == "cpu" for t in tensors):
        return rglru_scan_reference(a, b, h0)
    return rglru_scan_cuda(a.contiguous(), b.contiguous(),
                           None if h0 is None else h0.contiguous())
