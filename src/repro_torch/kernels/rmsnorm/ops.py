"""Public RMS-norm entry point: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or raises.  Nothing falls back from one to the other.  The kernel
takes any number of rows, so no padding is needed.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rms_norm_cuda
from repro_torch.kernels.rmsnorm.ref import rms_norm_reference


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D].  Normalised rows in ``x.dtype``."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rms_norm_reference(x, scale, eps)
    rows = x.reshape(-1, x.shape[-1])
    return rms_norm_cuda(rows.contiguous(), scale.contiguous(), eps).reshape(x.shape)
