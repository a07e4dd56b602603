"""Flash attention as CUDA kernels for Hopper: the forward and its gradient.

The forward is in ``csrc/flash_attention.cu``; it replaces the TPU kernel
``_flash_kernel`` of the JAX package, and can also write each query row's
log-sum-exp.  The backward is in ``csrc/flash_attention_bwd.cu`` (the JAX
package has no backward kernel: JAX differentiates its attention); it
rebuilds P from that log-sum-exp.  See the notes at the heads of both.  The
dtype picks the variant: bfloat16 runs ``wgmma`` on TMA-fed tiles, float32
runs on the CUDA cores.  This module builds each source at first use, binds
its C entry points with ctypes and launches on PyTorch's current stream.
``LAUNCHES`` and ``BACKWARD_LAUNCHES`` count every call of each wrapper,
``LAUNCHES_BY_VARIANT`` and ``BACKWARD_LAUNCHES_BY_VARIANT`` each
variant's, so a run can show that its work went through the kernels it
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
BACKWARD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
VARIANTS = {torch.bfloat16: "wgmma", torch.float32: "f32"}
HEAD_DIMS = (16, 32, 64, 128, 256)
TMA_ALIGN = 16  # bytes: the TMA unit's rule for a base address and a stride
ROW_PAD = 128  # the backward's row padding of lse and Delta (kRowPad)
# The keys a block of the backward's dK/dV pass owns: the f32 variant's
# tiles (kFB in csrc/flash_attention_bwd.cu), and the wgmma variant's by
# head_dim, 64 where its warpgroups split the work by role (D >= 128,
# KVShape) and 128 where each owns 64 keys (KVOwnShape).  The launch is
# given the value its split assumed and refuses any other.
BACKWARD_KEYS_PER_BLOCK = {"f32": {d: 32 for d in HEAD_DIMS},
                           "wgmma": {d: 64 if d >= 128 else 128 for d in HEAD_DIMS}}
# The grid the backward's dK/dV pass aims for: two blocks an SM of a 132-SM
# H100.  A constant, not the card's SM count, so that the split, and with
# it the gradients' bits, depend only on the shapes.
BACKWARD_TARGET_BLOCKS = 264

LAUNCHES = 0
LAUNCHES_BY_VARIANT = {"wgmma": 0, "f32": 0}
BACKWARD_LAUNCHES = 0
BACKWARD_LAUNCHES_BY_VARIANT = {"wgmma": 0, "f32": 0}
_count_lock = threading.Lock()


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first call only) and bind the kernel's library."""
    lib = load_library(SOURCE)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    for variant in VARIANTS.values():
        fn = getattr(lib, f"flash_attention_{variant}_launch")
        fn.argtypes = ([ptr] * 5 + [i32, i32, i32, i64, i64, i32] + [i64] * 12
                       + [i32, i64, ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_backward() -> ctypes.CDLL:
    """Build (first call only) and bind the backward's library."""
    lib = load_library(BACKWARD_SOURCE)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    for variant in VARIANTS.values():
        fn = getattr(lib, f"flash_attention_bwd_{variant}_launch")
        fn.argtypes = ([ptr] * 11 + [i32, i32, i32, i64, i64, i32] + [i64] * 24
                       + [i32, i64, ctypes.c_float, i32, i32, ptr])
        fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def backward_keys_per_block(variant: str, D: int) -> int:
    """The keys a block of the backward's dK/dV pass owns: a constant of
    the variant and the head_dim, so the split (and the gradients' bits)
    follows from the shapes alone, with no library or card asked."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    return BACKWARD_KEYS_PER_BLOCK[variant][D]


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


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  **same_as_q: torch.Tensor) -> str:
    """The variant for q [B, H, Sq, D] and k, v [B, KV, Skv, D] (and any
    tensors of q's shape, dtype and device in ``same_as_q``), or raise."""
    named = {"q": q, "k": k, "v": v, **same_as_q}
    for name, t in named.items():
        if not t.is_cuda or t.dtype not in VARIANTS or t.dim() != 4:
            raise ValueError(
                f"{name} must be a 4-D float32 or bfloat16 CUDA tensor, got "
                f"{t.dim()}-D {t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if (k.shape != (B, KV, Skv, D) or v.shape != k.shape
            or any(t.dtype != q.dtype or t.device != q.device for t in named.values())):
        raise ValueError(
            f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype} and "
            f"v {tuple(v.shape)} {v.dtype} must share batch, head_dim, dtype "
            f"and device, with k and v of one shape")
    for name, t in same_as_q.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have q's shape {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    return VARIANTS[q.dtype]


def _check_tma(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        why = tma_layout_error(t.shape, t.stride(), t.dtype, t.data_ptr())
        if why:
            raise ValueError(f"{name} cannot be read by the TMA unit: {why}")


def _like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor in t's layout where that keeps the last dimension
    contiguous, else a contiguous one."""
    out = torch.empty_like(t)
    return out if out.stride(-1) == 1 else torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _scale(D: int) -> float:
    # PyTorch divides a tensor by a scalar as a product with the float32
    # reciprocal of the float32 scalar; so do the kernels with sqrt(D).
    return 1.0 / ctypes.c_float(math.sqrt(D)).value


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         lse: torch.Tensor | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, KV, Skv, D] with KV dividing H.

    Any strides for the first three dimensions; the last must be
    contiguous.  bfloat16 takes the wgmma variant, whose TMA unit also
    needs 16-byte-aligned bases and strides (``tma_layout_error``); float32
    takes the CUDA-core variant.  The output has q's layout
    (``empty_like``).  Where ``lse`` is given (a contiguous float32 [B, H,
    Sq] CUDA tensor), the kernel also writes each query row's log-sum-exp
    of its scaled, masked scores into it (natural log; +inf for a row that
    sees no key), which the backward reads.  ``scale`` multiplies the scores
    (``_scale(D)`` without one).
    """
    global LAUNCHES
    variant = _check_inputs(q, k, v)
    if variant == "wgmma":
        _check_tma(q=q, k=k, v=v)
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if lse is not None and (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [B, H, Sq] = {(B, H, Sq)} "
                         f"tensor on {q.device}, got {tuple(lse.shape)} {lse.dtype}")
    out = _like(q)
    if out.numel() == 0:
        return out
    lib = load()
    launch = getattr(lib, f"flash_attention_{variant}_launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, KV, Sq, Skv, D, *tma_strides(q), *tma_strides(k),
            *tma_strides(v), *tma_strides(out), int(causal), window,
            _scale(D) if scale is None else scale, stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention ({variant}) launch failed: "
            + lib.flash_attention_error_string(err).decode())
    with _count_lock:
        LAUNCHES += 1
        LAUNCHES_BY_VARIANT[variant] += 1
    return out


def backward_split(keys_per_block: int, B: int, KV: int, G: int, Skv: int) -> int:
    """Blocks of the dK/dV pass that share one KV head's G query heads: the
    least divisor of G that gives the pass BACKWARD_TARGET_BLOCKS blocks,
    or G.  Where it is above 1 the pass writes float32 partial sums that a
    reduction adds in order; it depends only on the shapes, so the
    gradients' bits do too."""
    blocks = B * KV * -(-Skv // keys_per_block)
    return next(s for s in range(1, G + 1)
                if G % s == 0 and (blocks * s >= BACKWARD_TARGET_BLOCKS or s == G))


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  out: torch.Tensor, d_out: torch.Tensor,
                                  lse: torch.Tensor, *, causal: bool = True,
                                  window: int = 0, scale: float | None = None):
    """The gradient of ``flash_attention_cuda``: (dq, dk, dv) in the layouts
    of q, k and v (``empty_like``).

    q, out, d_out: [B, H, Sq, D]; k, v: [B, KV, Skv, D]; lse: the forward's
    contiguous float32 [B, H, Sq] log-sum-exp.  One dtype and device for the
    six tensors but lse, the last dimension contiguous; bfloat16 (the wgmma
    variant) also needs q, k, v and d_out readable by the TMA unit.
    ``scale`` is the forward's.
    """
    global BACKWARD_LAUNCHES
    variant = _check_inputs(q, k, v, out=out, d_out=d_out)
    if variant == "wgmma":
        _check_tma(q=q, k=k, v=v, d_out=d_out)
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [B, H, Sq] = {(B, H, Sq)} "
                         f"tensor on {q.device}, got {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = _like(q), _like(k), _like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    keys = backward_keys_per_block(variant, D)
    split = backward_split(keys, B, KV, H // KV, Skv)
    sq_pad = -(-Sq // ROW_PAD) * ROW_PAD
    aux = torch.empty((2, B, H, sq_pad), dtype=torch.float32, device=q.device)
    part = (torch.empty((2, split, B, KV, Skv, D), dtype=torch.float32, device=q.device)
            if split > 1 else None)
    lib = load_backward()
    launch = getattr(lib, f"flash_attention_bwd_{variant}_launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            *(t.data_ptr() for t in (q, k, v, out, d_out, lse, dq, dk, dv, aux)),
            None if part is None else part.data_ptr(),
            B, H, KV, Sq, Skv, D,
            *(st for t in (q, k, v, out, d_out, dq, dk, dv) for st in tma_strides(t)),
            int(causal), window, _scale(D) if scale is None else scale, split,
            keys, stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention backward ({variant}) launch failed: "
            + lib.flash_attention_bwd_error_string(err).decode())
    with _count_lock:
        BACKWARD_LAUNCHES += 1
        BACKWARD_LAUNCHES_BY_VARIANT[variant] += 1
    return dq, dk, dv
