"""Public Mandelbrot entry point: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or raises.  Nothing falls back from one to the other.  The kernel
masks the grid's ragged edge itself, so no padding is needed.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mandelbrot.kernel import mandelbrot_cuda
from repro_torch.kernels.mandelbrot.ref import mandelbrot_reference


def mandelbrot(x0: torch.Tensor, y0: torch.Tensor, *, max_iters: int = 1000):
    """Escape-time iterations + colour for a coordinate grid [H, W]."""
    if x0.device.type == "cpu" and y0.device.type == "cpu":
        return mandelbrot_reference(x0, y0, max_iters)
    return mandelbrot_cuda(x0, y0, max_iters)
