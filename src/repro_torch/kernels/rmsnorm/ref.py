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
