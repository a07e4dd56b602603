"""Kernels on local shards.

A kernel wrapper never sees a DTensor: each public entry point that may be
handed one (RMS norm, flash attention, the RG-LRU scan) redistributes its
inputs to placements the kernel can run on shard by shard, calls itself on
the local tensors and wraps the result back.  No collective runs inside a
kernel; any that the placements need belong to DTensor's redistribution
around it.  Under the preset rules each kernel is shard-local: RMS norm
normalises over ``d_model``, which the rules never shard; flash works on
local heads, and attention's ``seq`` is not sharded; the RG-LRU scan is
elementwise over ``rnn_state``.
"""

from __future__ import annotations

import sys

import torch


def is_dtensor(*tensors) -> bool:
    """Whether any argument is a DTensor (without importing DTensor where
    no code has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:
        return False
    return any(isinstance(t, mod.DTensor) for t in tensors if t is not None)


def whole(t):
    """A DTensor as its full tensor (a collective every rank of its mesh
    takes part in); anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def keep_shards(x, dims) -> tuple:
    """``x``'s placements with every ``Partial`` reduced and every shard of
    a dim outside ``dims`` gathered: what a kernel that is local over
    ``dims`` can take."""
    from torch.distributed.tensor import Replicate

    dims = {d % x.ndim for d in dims}
    return tuple(p if p.is_shard() and p.dim % x.ndim in dims else Replicate()
                 for p in x.placements)


def local(x, placements, grad_placements=None) -> torch.Tensor:
    """The local shard of DTensor ``x`` laid out as ``placements``."""
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.to_local(grad_placements=grad_placements)


def replicated(t, like) -> torch.Tensor:
    """A weight every shard needs whole (a plain tensor passes as it is).
    Its gradient is partial over every mesh dim on which ``like`` (the
    activation's local layout) is sharded: each shard saw only its rows."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate

    grad = tuple(Partial() if p.is_shard() else Replicate() for p in like)
    return local(t, (Replicate(),) * t.device_mesh.ndim, grad)


def wrap(out: torch.Tensor, like, placements, shape) -> torch.Tensor:
    """The local result ``out`` as a DTensor on ``like``'s mesh."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(out, like.device_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def row_placements(x) -> tuple:
    """``x``'s shards of its first (batch) dim, everything else gathered."""
    return keep_shards(x, (0,))


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree(fn, v) for v in tree)
    return tree if tree is None else fn(tree)


def run_over_rows(fn, x, params, *state, extra: str = "rows"):
    """``fn(x, params, *state) -> (out, extra)`` run on ``x``'s batch
    shards: a block whose rows are independent (the MoE FFN, routed per
    row; the xLSTM cells).  ``x``'s other dims and every weight are
    gathered whole (a weight's gradient is then partial over the shards);
    ``state`` leaves (batch first) take ``x``'s row shards.  ``out`` comes
    back with ``x``'s row placements.  ``extra`` is ``"rows"`` (batch-first
    tensors, placed like ``out``) or ``"means"`` (token means of the shard:
    their mean over the shards, as a partial sum, is the whole batch's)."""
    from torch.distributed.tensor import Partial

    rows = row_placements(x)
    mesh = x.device_mesh
    xl = local(x, rows)
    pl = _tree(lambda t: replicated(t, rows), params)
    sl = _tree(lambda t: local(t, rows) if is_dtensor(t) else t, state)
    out, more = fn(xl, pl, *sl)
    shards = 1
    for p, n in zip(rows, mesh.shape):
        shards *= n if p.is_shard() else 1
    out = wrap(out, x, rows, (x.shape[0],) + tuple(out.shape[1:]))
    if extra == "means":
        partial = tuple(Partial() if p.is_shard() else p for p in rows)
        more = _tree(lambda t: wrap(t / shards, x, partial, t.shape), more)
    else:
        more = _tree(lambda t: wrap(t, x, rows, (x.shape[0],) + tuple(t.shape[1:])),
                     more)
    return out, more


def place(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A whole tensor, the same on every rank, as a DTensor on ``mesh``:
    each rank keeps its own shard (no collective).  On a one-device mesh
    the tensor itself is the shard (no copy)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    local_shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, placements)
    if tuple(local_shape) == tuple(t.shape):
        local = t
    else:
        index = tuple(slice(o, o + n) for o, n in zip(offset, local_shape))
        local = t[index].contiguous().clone()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=contiguous_stride(t.shape))
