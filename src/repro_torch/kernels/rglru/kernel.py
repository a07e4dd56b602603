"""RG-LRU scan as a CUDA kernel for Hopper.

The kernel is ``csrc/rglru.cu`` (see the note at its head), a chunked
parallel scan over S; it replaces the TPU kernel ``_rglru_kernel`` of the
JAX package.  This module builds it at first use, binds its C entry point
with ctypes and launches it on PyTorch's current stream with the plan of
``chunk_plan``.  ``LAUNCHES`` counts the launches (one a call), so a run can
show that its work went through the kernel.

The gradient is ``csrc/rglru_bwd.cu`` (the TPU kernel had none): the
adjoint recurrence, the same chunked scan run from the end of S over the
same plan, one launch a call that reads a, h and gh in place and writes da,
db and dh0.  It is built and bound the same way (``load_backward``), and
the two sources share ``csrc/rglru_common.cuh``.  ``BACKWARD_LAUNCHES``
counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru.cu"
BACKWARD_SOURCE = SOURCE.with_name("rglru_bwd.cu")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NO_H0 = -1  # the dtype code that says h0 is absent (zeros)
MAX_BATCH = 65535  # the grid's z dimension
TILE = 16  # steps a thread loads at once: the shortest chunk
MAX_CHUNKS_PER_CTA = 8  # one warp a chunk
MAX_CTAS = 8  # CTAs of a cluster, the portable limit
MAX_CHUNKS = MAX_CHUNKS_PER_CTA * MAX_CTAS
CHUNKED_STRIPE = 32  # channels a CTA owns when S is chunked: a warp a chunk
SEQUENTIAL_STRIPE = 128  # channels a CTA owns for one chunk

LAUNCHES = 0
BACKWARD_LAUNCHES = 0
_count_lock = threading.Lock()


class ChunkPlan(NamedTuple):
    length: int  # L, steps a chunk
    chunks: int  # C, chunks over S
    per_cta: int  # chunks a CTA
    ctas: int  # CTAs a cluster, along the grid's y
    stripe: int  # channels a CTA, one a thread
    stripes: int  # the grid's x: ceil(W / stripe)


def chunk_plan(seq_len: int, width: int) -> ChunkPlan:
    """How a scan over ``seq_len`` steps of ``width`` channels is cut.

    It depends on S and W only, never on the batch: a row's h is the same
    bits whatever rows share its launch.  Chunks are at least one tile
    long, and up to 64 of them cover S, spread over up to 8 CTAs of a
    cluster; S <= TILE is one chunk, the sequential scan itself.
    """
    length = max(TILE, -(-seq_len // MAX_CHUNKS))
    chunks = max(1, -(-seq_len // length))
    per_cta = -(-chunks // MAX_CTAS)
    ctas = -(-chunks // per_cta)
    stripe = CHUNKED_STRIPE if chunks > 1 else SEQUENTIAL_STRIPE
    return ChunkPlan(length, chunks, per_cta, ctas, stripe, -(-width // stripe))


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first call only) and bind the kernel's library."""
    lib = load_library(SOURCE)
    fn = lib.rglru_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i32, i32, i32,
                   i64, i32, i32, i32, i32, i64, ptr]
    fn.restype = ctypes.c_int
    lib.rglru_error_string.argtypes = [ctypes.c_int]
    lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dim: int) -> None:
    if (not t.is_cuda or t.dtype not in DTYPE_CODES or t.dim() != dim
            or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {dim}-D float32 or bfloat16 CUDA "
            f"tensor, got {t.dim()}-D {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor | None = None):
    """a, b: [B, S, W] contiguous CUDA tensors, each f32 or bf16; h0: [B, W]
    (f32 or bf16) or None.  Returns (h in ``a.dtype``, h_last in f32)."""
    global LAUNCHES
    _check("a", a, 3)
    _check("b", b, 3)
    B, S, W = a.shape
    if b.shape != a.shape or b.device != a.device:
        raise ValueError(
            f"a {tuple(a.shape)} on {a.device} and b {tuple(b.shape)} on "
            f"{b.device} must share shape and device")
    if h0 is not None:
        _check("h0", h0, 2)
        if h0.shape != (B, W) or h0.device != a.device:
            raise ValueError(
                f"h0 must be [{B}, {W}] on {a.device}, got {tuple(h0.shape)} "
                f"on {h0.device}")
    if B > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} rows, got {B}")
    h = torch.empty_like(a)
    h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    if B == 0 or W == 0:
        return h, h_last
    plan = chunk_plan(S, W)
    lib = load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_launch(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            h_last.data_ptr(), B, S, W, DTYPE_CODES[a.dtype],
            DTYPE_CODES[b.dtype],
            NO_H0 if h0 is None else DTYPE_CODES[h0.dtype], *plan, stream)
    if err != 0:
        raise RuntimeError(
            "rglru kernel launch failed: "
            + lib.rglru_error_string(err).decode())
    with _count_lock:
        LAUNCHES += 1
    return h, h_last


@functools.cache
def load_backward() -> ctypes.CDLL:
    """Build (first call only) and bind the backward kernel's library."""
    lib = load_library(BACKWARD_SOURCE)
    fn = lib.rglru_bwd_launch
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [ptr] * 8 + [i64, i64, i64, i32, i32, i64, i32, i32, i32, i32,
                               i64, ptr]
    fn.restype = ctypes.c_int
    lib.rglru_bwd_error_string.argtypes = [ctypes.c_int]
    lib.rglru_bwd_error_string.restype = ctypes.c_char_p
    return lib


def rglru_scan_backward_cuda(a: torch.Tensor, h: torch.Tensor,
                             h0: torch.Tensor | None, gh: torch.Tensor,
                             g_last: torch.Tensor):
    """Gradient of ``rglru_scan_cuda`` at (a, h0) given every h it produced,
    for upstream gradients ``gh`` (of h) and ``g_last`` (of h_last): a, h
    and gh [B, S, W] contiguous CUDA tensors of one dtype (f32 or bf16),
    g_last [B, W] f32, h0 [B, W] f32 or bf16 or None.
    Returns (da, db) in f32 and dh0 in h0's dtype (or None), bit for bit
    ``ref.rglru_scan_backward_chunked`` at ``chunk_plan(S, W).length``."""
    global BACKWARD_LAUNCHES
    _check("a", a, 3)
    _check("h", h, 3)
    _check("gh", gh, 3)
    B, S, W = a.shape
    for name, t in (("h", h), ("gh", gh)):
        if t.shape != a.shape or t.dtype != a.dtype or t.device != a.device:
            raise ValueError(
                f"{name} must have a's shape {tuple(a.shape)}, dtype {a.dtype} "
                f"and device {a.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")
    _check("g_last", g_last, 2)
    if (g_last.dtype != torch.float32 or g_last.shape != (B, W)
            or g_last.device != a.device):
        raise ValueError(
            f"g_last must be float32 [{B}, {W}] on {a.device}, got {g_last.dtype} "
            f"{tuple(g_last.shape)} on {g_last.device}")
    if h0 is not None:
        _check("h0", h0, 2)
        if h0.shape != (B, W) or h0.device != a.device:
            raise ValueError(
                f"h0 must be [{B}, {W}] on {a.device}, got {tuple(h0.shape)} "
                f"on {h0.device}")
    if B > MAX_BATCH:
        raise ValueError(f"at most {MAX_BATCH} rows, got {B}")
    da = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    db = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if S == 0 or B == 0 or W == 0:  # nothing reaches h0 (the construction's zeros)
        return da, db, None if dh0 is None else dh0.zero_()
    plan = chunk_plan(S, W)
    lib = load_backward()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_bwd_launch(
            a.data_ptr(), h.data_ptr(), gh.data_ptr(), g_last.data_ptr(),
            None if h0 is None else h0.data_ptr(), da.data_ptr(), db.data_ptr(),
            None if dh0 is None else dh0.data_ptr(), B, S, W, DTYPE_CODES[a.dtype],
            NO_H0 if h0 is None else DTYPE_CODES[h0.dtype], *plan, stream)
    if err != 0:
        raise RuntimeError(
            "rglru backward kernel launch failed: "
            + lib.rglru_bwd_error_string(err).decode())
    with _count_lock:
        BACKWARD_LAUNCHES += 1
    return da, db, dh0
