"""Plain PyTorch version of the fused RMS norm (the JAX package's
``rms_norm_reference``): computed in f32, cast back to ``x.dtype``."""

from __future__ import annotations

import torch


def rms_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D] (zero-centred: output *= (1 + scale))."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rms_norm_backward_reference(x: torch.Tensor, scale: torch.Tensor,
                                g: torch.Tensor, eps: float = 1e-6):
    """The explicit gradient of ``rms_norm_reference`` for the upstream
    gradient ``g``, in f32: with r = rsqrt(mean(x^2) + eps) and
    gs = g * (1 + scale),

        dx = r * gs - (x * r^3) * mean(x * gs),  dscale = sum_rows g * (x * r).

    Returns (dx in ``x.dtype``, dscale in ``scale.dtype``).  The CUDA
    backward kernel rounds as this does, operation by operation.
    """
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gs = gf * (1.0 + scale.float())
    mean_dot = torch.mean(xf * gs, dim=-1, keepdim=True)
    dx = r * gs - xf * (r * r * r) * mean_dot
    dscale = (gf * (xf * r)).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
