"""Flash attention (forward) as CUDA kernels for Hopper.

The kernels are in ``csrc/flash_attention.cu`` (see the note at its head);
they replace the TPU kernel ``_flash_kernel`` of the JAX package.  The
dtype picks the variant: bfloat16 runs ``wgmma`` on TMA-fed tiles, float32
runs on the CUDA cores.  This module builds the source at first use, binds
its C entry points with ctypes and launches on PyTorch's current stream.
``LAUNCHES`` counts every launch and ``LAUNCHES_BY_VARIANT`` each
variant's, so a run can show that its work went through the kernel it
expects.
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
VARIANTS = {torch.bfloat16: "wgmma", torch.float32: "f32"}
HEAD_DIMS = (16, 32, 64, 128, 256)
TMA_ALIGN = 16  # bytes: the TMA unit's rule for a base address and a stride

LAUNCHES = 0
LAUNCHES_BY_VARIANT = {"wgmma": 0, "f32": 0}
_count_lock = threading.Lock()


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first call only) and bind the kernel's library."""
    lib = load_library(SOURCE)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    for variant in VARIANTS.values():
        fn = getattr(lib, f"flash_attention_{variant}_launch")
        fn.argtypes = ([ptr] * 4 + [i32, i32, i32, i64, i64, i32] + [i64] * 12
                       + [i32, i64, ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def tma_layout_error(shape, strides, dtype: torch.dtype, ptr: int) -> str | None:
    """Why the wgmma variant cannot read a [B, heads, S, D] tensor through
    a TMA tensor map, or None if it can.

    The rule: bfloat16, four dimensions, the last contiguous with a head dim
    in ``HEAD_DIMS``, a base address and every other stride (in bytes) a
    multiple of 16.  A dimension of size 1 is never stepped along, so its
    stride does not count (``tma_strides`` replaces it).
    """
    if dtype != torch.bfloat16:
        return f"dtype {dtype} is not bfloat16"
    if len(shape) != 4 or len(strides) != 4:
        return f"{len(shape)}-D, not [B, heads, S, D]"
    if strides[-1] != 1:
        return f"last dimension has stride {strides[-1]}, not 1"
    if shape[-1] not in HEAD_DIMS:
        return f"head_dim {shape[-1]} not in {HEAD_DIMS}"
    if ptr % TMA_ALIGN:
        return f"base address {ptr:#x} is not a multiple of {TMA_ALIGN} bytes"
    for dim in range(3):  # two bytes an element
        if shape[dim] > 1 and (strides[dim] * 2) % TMA_ALIGN:
            return (f"stride {strides[dim]} of dimension {dim} is not a "
                    f"multiple of {TMA_ALIGN} bytes")
    return None


def tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """t's strides for B, heads and S, with a dimension of size 1 given the
    row length D, which is a valid TMA stride and never stepped along."""
    return tuple(st if n > 1 else t.shape[-1]
                 for n, st in zip(t.shape[:3], t.stride()[:3]))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, KV, Skv, D] with KV dividing H.

    Any strides for the first three dimensions; the last must be
    contiguous.  bfloat16 takes the wgmma variant, whose TMA unit also
    needs 16-byte-aligned bases and strides (``tma_layout_error``); float32
    takes the CUDA-core variant.  The output has q's layout
    (``empty_like``).
    """
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype not in VARIANTS or t.dim() != 4:
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
    variant = VARIANTS[q.dtype]
    if variant == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            why = tma_layout_error(t.shape, t.stride(), t.dtype, t.data_ptr())
            if why:
                raise ValueError(f"{name} cannot be read by the TMA unit: {why}")
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # PyTorch divides a tensor by a scalar as a product with the float32
    # reciprocal of the float32 scalar; so do the kernels with sqrt(D).
    sm_scale = 1.0 / ctypes.c_float(math.sqrt(D)).value
    lib = load()
    launch = getattr(lib, f"flash_attention_{variant}_launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Skv, D, *tma_strides(q), *tma_strides(k),
            *tma_strides(v), *tma_strides(out), int(causal), window, sm_scale,
            stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention ({variant}) launch failed: "
            + lib.flash_attention_error_string(err).decode())
    with _count_lock:
        LAUNCHES += 1
        LAUNCHES_BY_VARIANT[variant] += 1
    return out
