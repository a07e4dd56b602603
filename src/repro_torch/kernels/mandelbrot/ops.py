"""Public Mandelbrot entry points: the device picks the path.

A CPU device takes the plain PyTorch version; a CUDA device takes the CUDA
kernel, or raises.  Nothing falls back from one to the other.  The kernel
masks the grid's ragged edge itself, so no padding is needed.

Both entries are ``torch.library`` custom ops (``repro_torch::mandelbrot``,
``repro_torch::mandelbrot_line``) with fake impls (shapes and dtypes only).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.mandelbrot.kernel import (
    mandelbrot_cuda,
    mandelbrot_line_cuda,
)
from repro_torch.kernels.mandelbrot.ref import (
    line_params,
    line_stats_reference,
    mandelbrot_reference,
)


def _mandelbrot_impl(x0: torch.Tensor, y0: torch.Tensor,
                     max_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    if x0.device.type == "cpu" and y0.device.type == "cpu":
        return mandelbrot_reference(x0, y0, max_iters)
    return mandelbrot_cuda(x0, y0, max_iters)


# Run on CPU and CUDA tensors; a fake or meta tensor takes the fake impl.
_mandelbrot = torch.library.custom_op("repro_torch::mandelbrot",
                                      _mandelbrot_impl, mutates_args=())


@_mandelbrot.register_fake
def _mandelbrot_fake(x0, y0, max_iters):
    return (torch.empty_like(x0, dtype=torch.int32),
            torch.empty_like(x0, dtype=torch.int32))


@torch.library.custom_op("repro_torch::mandelbrot_line", mutates_args=())
def _mandelbrot_line(width: int, y: float, min_x: float, delta: float,
                     max_iters: int, device: torch.device) -> torch.Tensor:
    return mandelbrot_line_cuda(width, y, min_x, delta, max_iters, device)


@_mandelbrot_line.register_fake
def _mandelbrot_line_fake(width, y, min_x, delta, max_iters, device):
    return torch.empty(2, dtype=torch.int64, device=device)


def mandelbrot(x0: torch.Tensor, y0: torch.Tensor, *, max_iters: int = 1000):
    """Escape-time iterations + colour for a coordinate grid [H, W]."""
    return _mandelbrot(x0, y0, max_iters)


def mandelbrot_line_stats(width: int, line_y: int, max_iters: int, *,
                          device=None) -> torch.Tensor:
    """One work item of the paper's job: line ``line_y`` of ``width`` points
    (``line_coords``) counted to ``max_iters`` -> int64 [2] on ``device``:
    (points that escaped, the sum of their iteration counts).

    On a CUDA device (the default) this is one launch of the line kernel
    beside the zeroing of its output; on the CPU, the plain version.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return line_stats_reference(width, line_y, max_iters)
    y, min_x, delta = line_params(width, line_y)
    return _mandelbrot_line(width, y, min_x, delta, max_iters, dev)
