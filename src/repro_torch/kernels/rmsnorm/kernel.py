"""Fused RMS norm as a CUDA kernel for Hopper.

The kernel is ``csrc/rmsnorm.cu`` (see the note at its head); it replaces
the TPU kernel ``_rmsnorm_kernel`` of the JAX package.  This module builds
it at first use, binds its C entry point with ctypes and launches it on
PyTorch's current stream with the plan of ``launch_plan``.  ``LAUNCHES``
counts the launches, so a run can show that its work went through the
kernel.

The gradient is ``csrc/rmsnorm_bwd.cu`` (the TPU kernel had none), built
and bound the same way, cut over threads with a plan of its own
(``backward_plan`` and ``backward_blocks``); ``BACKWARD_LAUNCHES`` counts
its calls (two launches each: the rows, then the column sums of
``dscale``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
BACKWARD_SOURCE = SOURCE.with_name("rmsnorm_bwd.cu")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

UNIT_BYTES = 16  # x's bytes in one vector unit
PER_THREAD = 2  # units a thread holds at most (kPer in the source)
MAX_THREADS = 1024  # threads of one row at most
BLOCK_THREADS = 256  # narrow rows share a block of up to this many threads
# The backward (kPer, kMaxBlock and kMaxGroups in csrc/rmsnorm_bwd.cu):
# up to four units of x and of g a thread, row groups sharing a block of up
# to BACKWARD_GROUP_THREADS threads, each lane keeping BACKWARD_RING (or 2)
# rows in flight through shared memory where they fit in BACKWARD_SMEM
# bytes, on a grid of BACKWARD_BLOCKS blocks at most (one an SM of an H100;
# a constant, so that the order of dscale's sums never depends on the
# card), so that ``partial`` holds at most that many rows of D floats.
BACKWARD_PER_THREAD = 4
BACKWARD_BLOCK_THREADS = 512
BACKWARD_GROUP_THREADS = 384
BACKWARD_MAX_GROUPS = 8
BACKWARD_RING = 4
BACKWARD_SMEM = 200 * 1024
BACKWARD_BLOCKS = 128

LAUNCHES = 0
BACKWARD_LAUNCHES = 0
_count_lock = threading.Lock()


class Plan(NamedTuple):
    unit: int  # elements of a unit: 16 bytes of x, or 1
    threads: int  # threads of one row, a multiple of 32
    rows_per_block: int


class BackwardPlan(NamedTuple):
    unit: int  # elements of a unit: 16 bytes of x, or 1
    threads: int  # threads of one row, a multiple of 32
    groups: int  # row groups (lanes) of a block
    ring: int  # rows a lane keeps in flight in shared memory; 0: in registers


def launch_plan(cols: int, dtype: torch.dtype) -> Plan:
    """How a row of ``cols`` elements of ``dtype`` is cut over threads.

    It depends on the row's width and type only, never on the number of
    rows: a row reduces in the same order whatever launch it is in.  A row
    takes enough threads that each holds one or two units where it can.
    """
    vec = UNIT_BYTES // torch.empty((), dtype=dtype).element_size()
    unit = vec if cols % vec == 0 else 1
    units = cols // unit
    threads = -(-units // (32 * PER_THREAD)) * 32  # ceil(units / 2), in warps
    if threads > MAX_THREADS:
        raise ValueError(f"rows of {cols} {dtype} elements are wider than the "
                         f"kernel's {PER_THREAD * MAX_THREADS} units of {unit}")
    return Plan(unit, threads, max(1, BLOCK_THREADS // threads))


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first call only) and bind the kernel's library."""
    lib = load_library(SOURCE)
    fn = lib.rmsnorm_launch
    i32 = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, i32, i32, i32, i32, i32,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def backward_plan(cols: int, dtype: torch.dtype) -> BackwardPlan:
    """How the backward cuts a row of ``cols`` elements of ``dtype``: up to
    four units of x (and of g) a thread; as many such row groups to a block
    as fit in 384 threads (at most 8); and a ring of BACKWARD_RING rows a
    lane in shared memory (or of 2) where the rows are whole 16-byte units
    and the ring fits.  Like ``launch_plan`` it depends on the row's width
    and type only, so a row's dx reduces in the same order in every
    launch."""
    size = torch.empty((), dtype=dtype).element_size()
    vec = UNIT_BYTES // size
    unit = vec if cols % vec == 0 else 1
    units = cols // unit
    threads = -(-units // (32 * BACKWARD_PER_THREAD)) * 32
    if threads > BACKWARD_BLOCK_THREADS:
        raise ValueError(f"rows of {cols} {dtype} elements are wider than the backward's "
                         f"{BACKWARD_PER_THREAD * BACKWARD_BLOCK_THREADS} units of {unit}")
    groups = max(1, min(BACKWARD_MAX_GROUPS, BACKWARD_GROUP_THREADS // threads))
    fits = [r for r in (BACKWARD_RING, 2) if unit == vec and 4 * cols * (1 + groups)
            + groups * r * (2 * cols * size + 8) <= BACKWARD_SMEM]
    return BackwardPlan(unit, threads, groups, fits[0] if fits else 0)


def backward_blocks(rows: int, plan: BackwardPlan) -> int:
    """Blocks of the backward's first pass, each writing one row of
    ``partial``: a row a lane where that takes fewer than BACKWARD_BLOCKS
    blocks, else BACKWARD_BLOCKS.  Lane l walks rows l, l + lanes, ..., so
    the order of ``dscale``'s sums depends on N and the plan only, never on
    the card."""
    return max(1, min(-(-rows // plan.groups), BACKWARD_BLOCKS))


@functools.cache
def load_backward() -> ctypes.CDLL:
    """Build (first call only) and bind the backward kernel's library."""
    lib = load_library(BACKWARD_SOURCE)
    fn = lib.rmsnorm_bwd_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 6 + [ctypes.c_int64, ctypes.c_int64] + [i32] * 7 \
        + [ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    lib.rmsnorm_bwd_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(x: torch.Tensor, scale: torch.Tensor) -> None:
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where a view starts off a 16-byte boundary."""
    return t if t.data_ptr() % UNIT_BYTES == 0 else t.clone()


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x: [N, D] contiguous f32/bf16 CUDA tensor; scale: [D] f32/bf16."""
    global LAUNCHES
    _check_rows(x, scale)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    plan = launch_plan(x.shape[1], x.dtype)
    if plan.unit > 1:  # vector loads: a view off a 16-byte boundary is copied
        x, scale = _aligned(x), _aligned(scale)
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype], *plan,
            eps, stream)
    if err != 0:
        raise RuntimeError(
            "rmsnorm kernel launch failed: "
            + lib.rmsnorm_error_string(err).decode())
    with _count_lock:
        LAUNCHES += 1
    return out


def rms_norm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient of ``rms_norm_cuda`` at (x, scale) for the upstream gradient
    ``g`` (x's shape and type).  Returns (dx in x's type, dscale in
    scale's type)."""
    global BACKWARD_LAUNCHES
    _check_rows(x, scale)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous():
        raise ValueError(
            f"g must be a contiguous {tuple(x.shape)} {x.dtype} tensor on "
            f"{x.device}, got {tuple(g.shape)} {g.dtype} on {g.device}")
    if x.numel() == 0:
        return torch.empty_like(x), torch.zeros_like(scale)
    plan = backward_plan(x.shape[1], x.dtype)
    if plan.unit > 1:
        x, g = _aligned(x), _aligned(g)
    blocks = backward_blocks(x.shape[0], plan)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    partial = torch.empty((blocks, x.shape[1]), dtype=torch.float32, device=x.device)
    lib = load_backward()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rmsnorm_bwd_launch(
            x.data_ptr(), g.data_ptr(), scale.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), partial.data_ptr(), x.shape[0], x.shape[1],
            DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype], *plan, blocks, eps,
            stream)
    if err != 0:
        raise RuntimeError(
            "rmsnorm backward kernel launch failed: "
            + lib.rmsnorm_bwd_error_string(err).decode())
    with _count_lock:
        BACKWARD_LAUNCHES += 1
    return dx, dscale
