"""AdamW's update of one leaf as a CUDA kernel for Hopper.

The kernel is ``csrc/adamw.cu`` (see the note at its head); it replaces no
TPU kernel (XLA fuses the JAX package's update).  This module builds it at
first use with ``-fmad=false``, binds its C entry point with ctypes and
launches it on PyTorch's current stream.  ``LAUNCHES`` counts the
launches, so a run can show that its update went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import threading
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"
# No contraction beyond what the source spells out: the update must equal
# the plain version's bit for bit (see the note at the head of the source).
FLAGS = ("-fmad=false",)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0
_count_lock = threading.Lock()


def f32(x: float) -> float:
    """``x`` rounded to the nearest float32, as PyTorch rounds a Python
    scalar that meets a float32 tensor."""
    return struct.unpack("f", struct.pack("f", x))[0]


def host_constants(b1: float, b2: float, eps: float,
                   weight_decay: float) -> tuple[float, ...]:
    """(b1, 1 - b1, b2, 1 - b2, eps, weight_decay), each computed in
    Python and rounded once to float32: the constants the plain version's
    launches use."""
    return tuple(f32(c) for c in (b1, 1 - b1, b2, 1 - b2, eps, weight_decay))


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first call only) and bind the kernel's library."""
    lib = load_library(SOURCE, FLAGS)
    fn = lib.adamw_launch
    ptr = ctypes.c_void_p
    fn.argtypes = ([ptr] * 8 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_float] * 6 + [ptr])
    fn.restype = ctypes.c_int
    lib.adamw_error_string.argtypes = [ctypes.c_int]
    lib.adamw_error_string.restype = ctypes.c_char_p
    return lib


def adamw_update_cuda(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      v: torch.Tensor, scale: torch.Tensor, b1c: torch.Tensor,
                      b2c: torch.Tensor, lr: torch.Tensor,
                      consts: tuple[float, ...]) -> None:
    """One AdamW step of one leaf in one launch: ``p``, ``m`` and ``v``
    updated in place.  p and g: contiguous f32 or bf16 CUDA tensors of one
    type and size; m and v: contiguous f32 or bf16, one type; scale, b1c,
    b2c and lr: 0-d f32 tensors on the same device; ``consts`` from
    ``host_constants``."""
    global LAUNCHES
    if p.dtype not in DTYPE_CODES or g.dtype != p.dtype or m.dtype not in DTYPE_CODES \
            or v.dtype != m.dtype:
        raise ValueError(f"p and g must share float32 or bfloat16, m and v too; got "
                         f"{p.dtype}, {g.dtype}, {m.dtype}, {v.dtype}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.device != p.device or not t.is_contiguous() or t.numel() != p.numel():
            raise ValueError(
                f"{name} must be a contiguous tensor of {p.numel()} elements on "
                f"{p.device}, got {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    for name, t in (("scale", scale), ("b1c", b1c), ("b2c", b2c), ("lr", lr)):
        if t.dim() != 0 or t.dtype != torch.float32 or t.device != p.device:
            raise ValueError(f"{name} must be a 0-d float32 tensor on {p.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not p.is_cuda:
        raise ValueError(f"the AdamW kernel runs on a CUDA device, got {p.device}")
    if p.numel() == 0:
        return
    lib = load()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.adamw_launch(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), scale.data_ptr(),
            b1c.data_ptr(), b2c.data_ptr(), lr.data_ptr(), p.numel(),
            DTYPE_CODES[p.dtype], DTYPE_CODES[m.dtype], *consts, stream)
    if err != 0:
        raise RuntimeError("adamw kernel launch failed: "
                           + lib.adamw_error_string(err).decode())
    with _count_lock:
        LAUNCHES += 1
