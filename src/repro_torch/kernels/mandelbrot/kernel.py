"""Mandelbrot escape time as a CUDA kernel for Hopper.

The kernel is ``csrc/mandelbrot.cu`` (see the note at its head); it replaces
the TPU kernel ``_mandelbrot_kernel`` of the JAX package.  This module builds
it at first use, binds its two C entry points with ctypes and launches them
on PyTorch's current stream: ``mandelbrot_cuda`` counts a grid of given
coordinates, ``mandelbrot_line_cuda`` does one line of the paper's job
(coordinates, counts and the line's sums) in one launch.  ``LAUNCHES``
counts the launches of both, so a run can show that its work went through
the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "mandelbrot.cu"
# No contraction beyond what the source spells out: the counts must equal
# the reference's bit for bit (see the note at the head of the source).
FLAGS = ("-fmad=false",)

LAUNCHES = 0
_count_lock = threading.Lock()


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first call only) and bind the kernel's library."""
    lib = load_library(SOURCE, FLAGS)
    fn = lib.mandelbrot_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    line = lib.mandelbrot_line_launch
    line.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p]
    line.restype = ctypes.c_int
    lib.mandelbrot_chunk.argtypes = []
    lib.mandelbrot_chunk.restype = ctypes.c_int
    lib.mandelbrot_error_string.argtypes = [ctypes.c_int]
    lib.mandelbrot_error_string.restype = ctypes.c_char_p
    return lib


def mandelbrot_cuda(x0: torch.Tensor, y0: torch.Tensor, max_iters: int):
    """x0/y0: [H, W] contiguous f32 CUDA tensors -> (iterations, colour) i32."""
    for name, t in (("x0", x0), ("y0", y0)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 CUDA tensor, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if x0.dim() != 2 or x0.shape != y0.shape or x0.device != y0.device:
        raise ValueError(
            f"x0 and y0 must be [H, W] on one device, got {tuple(x0.shape)} "
            f"on {x0.device} and {tuple(y0.shape)} on {y0.device}")
    _check_max_iters(max_iters)
    iters = torch.empty(x0.shape, dtype=torch.int32, device=x0.device)
    colour = torch.empty(x0.shape, dtype=torch.int32, device=x0.device)
    if x0.numel() == 0:
        return iters, colour
    lib = load()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mandelbrot_launch(
            x0.data_ptr(), y0.data_ptr(), iters.data_ptr(), colour.data_ptr(),
            x0.shape[0], x0.shape[1], max_iters, stream)
    _count(lib, err)
    return iters, colour


def mandelbrot_line_cuda(width: int, y: float, min_x: float, delta: float,
                         max_iters: int, device) -> torch.Tensor:
    """One line of ``width`` points in one launch -> int64 [2] on ``device``:
    (points that escaped, the sum of their iteration counts).

    Point ``i`` is ``x = min_x + i * delta`` in float32 (product, then sum,
    each rounded, with ``min_x`` and ``delta`` rounded to float32 first, as
    ``line_coords`` computes it) and the row's ``y`` rounded to float32.
    """
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the line kernel runs on a CUDA device, got {device}")
    if not 0 < width < 2**31:
        raise ValueError(f"width must be in [1, 2**31), got {width}")
    _check_max_iters(max_iters)
    out = torch.zeros(2, dtype=torch.int64, device=device)
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mandelbrot_line_launch(width, y, min_x, delta, max_iters,
                                         out.data_ptr(), stream)
    _count(lib, err)
    return out


def chunk() -> int:
    """Trips the kernel runs between two escape branches (its ``kChunk``)."""
    return load().mandelbrot_chunk()


def _check_max_iters(max_iters: int) -> None:
    if not 0 <= max_iters < 2**31:
        raise ValueError(f"max_iters must fit an int32, got {max_iters}")


def _count(lib: ctypes.CDLL, err: int) -> None:
    """Raise if a launch failed, else count it."""
    global LAUNCHES
    if err != 0:
        raise RuntimeError(
            "mandelbrot kernel launch failed: "
            + lib.mandelbrot_error_string(err).decode())
    with _count_lock:
        LAUNCHES += 1
