"""Fused RMS norm as a CUDA kernel for Hopper.

The kernel is ``csrc/rmsnorm.cu`` (see the note at its head); it replaces
the TPU kernel ``_rmsnorm_kernel`` of the JAX package.  This module builds
it at first use, binds its C entry point with ctypes and launches it on
PyTorch's current stream.  ``LAUNCHES`` counts the launches, so a run can
show that its work went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0
_count_lock = threading.Lock()


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first call only) and bind the kernel's library."""
    lib = load_library(SOURCE)
    fn = lib.rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x: [N, D] contiguous f32/bf16 CUDA tensor; scale: [D] f32/bf16."""
    global LAUNCHES
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_cuda or t.dtype not in DTYPE_CODES or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 or bfloat16 CUDA tensor, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if (x.dim() != 2 or scale.shape != (x.shape[1],)
            or x.device != scale.device):
        raise ValueError(
            f"x must be [N, D] and scale [D] on one device, got "
            f"{tuple(x.shape)} on {x.device} and {tuple(scale.shape)} on "
            f"{scale.device}")
    if x.shape[0] >= 2**31:
        raise ValueError(f"at most 2**31 - 1 rows, got {x.shape[0]}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype], eps,
            stream)
    if err != 0:
        raise RuntimeError(
            "rmsnorm kernel launch failed: "
            + lib.rmsnorm_error_string(err).decode())
    with _count_lock:
        LAUNCHES += 1
    return out
