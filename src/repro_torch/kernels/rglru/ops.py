"""Public RG-LRU scan entry point: the tensors' device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or raises.  Nothing falls back from one to the other.  The kernel
masks a ragged W itself, so no padding is needed (the JAX package's
``ops.rglru_scan`` pads W to its 128-lane blocks).

Where a gradient is wanted, the call goes through ``RGLRUScanFunction``: its
backward is the adjoint recurrence (``ref.rglru_scan_backward``), run by the
same scan on reversed inputs: the plain version on CPU tensors and the
CUDA kernel on CUDA tensors, so the backward needs no kernel of its own.
Without autograd (serving), the scan is called directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru.kernel import rglru_scan_backward_cuda, rglru_scan_cuda
from repro_torch.kernels.rglru.ref import rglru_scan_backward, rglru_scan_reference


def _scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None):
    tensors = (a, b) if h0 is None else (a, b, h0)
    if all(t.device.type == "cpu" for t in tensors):
        return rglru_scan_reference(a, b, h0)
    return rglru_scan_cuda(a.contiguous(), b.contiguous(),
                           None if h0 is None else h0.contiguous())


class RGLRUScanFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = _scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.b_dtype = b.dtype
        return h, h_last

    @staticmethod
    def backward(ctx, gh, g_last):
        a, h, h0 = ctx.saved_tensors
        if a.device.type == "cpu":
            da, db, dh0 = rglru_scan_backward(a, h, h0, gh, g_last,
                                              rglru_scan_reference)
        else:
            da, db, dh0 = rglru_scan_backward_cuda(a, h, h0, gh, g_last)
        return da.to(a.dtype), db.to(ctx.b_dtype), dh0


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None):
    """a, b: [B, S, W]; h0: [B, W] or None.  Returns (h [B, S, W] in
    ``a.dtype``, h_last [B, W] in float32)."""
    tensors = (a, b) if h0 is None else (a, b, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return RGLRUScanFunction.apply(a, b, h0)
    return _scan(a, b, h0)
