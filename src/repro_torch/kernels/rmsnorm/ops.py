"""Public RMS-norm entry point: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or raises.  Nothing falls back from one to the other.  The kernel
takes any number of rows, so no padding is needed.

Where a gradient is wanted, the call goes through ``RMSNormFunction``: its
forward is the path above, and its backward the explicit gradient, as the
plain version (``rms_norm_backward_reference``) on CPU tensors and as the
CUDA backward kernel on CUDA tensors.  Without autograd (serving), the
forward is called directly and records nothing.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rms_norm_bwd_cuda, rms_norm_cuda
from repro_torch.kernels.rmsnorm.ref import (
    rms_norm_backward_reference,
    rms_norm_reference,
)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if _on_cpu(x, scale):
        return rms_norm_reference(x, scale, eps)
    rows = x.reshape(-1, x.shape[-1])
    return rms_norm_cuda(rows.contiguous(), scale.contiguous(), eps).reshape(x.shape)


def _backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
              eps: float):
    """Gradient at (x, scale) for the upstream gradient ``g``: (dx in
    ``x.dtype``, dscale in ``scale.dtype``)."""
    if _on_cpu(x, scale, g):
        return rms_norm_backward_reference(x, scale, g, eps)
    D = x.shape[-1]
    dx, dscale = rms_norm_bwd_cuda(
        x.reshape(-1, D).contiguous(), scale.contiguous(),
        g.reshape(-1, D).contiguous().to(x.dtype), eps)
    return dx.reshape(x.shape), dscale


class RMSNormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = _backward(x, scale, g, ctx.eps)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D].  Normalised rows in ``x.dtype``."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFunction.apply(x, scale, eps)
    return _forward(x, scale, eps)
