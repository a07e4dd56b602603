"""Flash attention (forward) as a CUDA kernel for Hopper.

The kernel is ``csrc/flash_attention.cu`` (see the note at its head); it
replaces the TPU kernel ``_flash_kernel`` of the JAX package.  This module
builds it at first use, binds its C entry point with ctypes and launches it
on PyTorch's current stream.  ``LAUNCHES`` counts the launches, so a run can
show that its work went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)

LAUNCHES = 0
_count_lock = threading.Lock()


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first call only) and bind the kernel's library."""
    lib = load_library(SOURCE)
    fn = lib.flash_attention_launch
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    fn.argtypes = ([ptr] * 4 + [i32, i32, i32, i64, i64, i32] + [i64] * 12
                   + [i32, i64, ctypes.c_float, i32, ptr])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, KV, Skv, D] with KV dividing H.

    Any strides for the first three dimensions; the last must be
    contiguous.  The output has q's layout (``empty_like``).
    """
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype not in DTYPE_CODES or t.dim() != 4:
            raise ValueError(
                f"{name} must be a 4-D float32 or bfloat16 CUDA tensor, got "
                f"{t.dim()}-D {t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if (k.shape != (B, KV, Skv, D) or v.shape != k.shape
            or q.dtype != k.dtype or q.dtype != v.dtype
            or not q.device == k.device == v.device):
        raise ValueError(
            f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype} and "
            f"v {tuple(v.shape)} {v.dtype} must share batch, head_dim, dtype "
            f"and device, with k and v of one shape")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # PyTorch divides a tensor by a scalar as a product with the float32
    # reciprocal of the float32 scalar; so does the kernel with sqrt(D).
    sm_scale = 1.0 / ctypes.c_float(math.sqrt(D)).value
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Skv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), window, sm_scale,
            DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            "flash attention kernel launch failed: "
            + lib.flash_attention_error_string(err).decode())
    with _count_lock:
        LAUNCHES += 1
    return out
