"""Kernels on local shards.

A kernel wrapper never sees a DTensor: each public entry point that may be
handed one (RMS norm, flash attention, the RG-LRU scan) redistributes its
inputs to placements the kernel can run on shard by shard, calls itself on
the local tensors and wraps the result back.  No collective runs inside a
kernel; any that the placements need belong to DTensor's redistribution
around it.  Under the preset rules each kernel is shard-local: RMS norm
normalises over ``d_model``, which the rules never shard; flash works on
local heads, and attention's ``seq`` is not sharded; the RG-LRU scan is
elementwise over ``rnn_state``.  Blocks that are not kernels run here
too: on their batch rows (``run_over_rows``, the xLSTM cells), or on their
rows and their weights' shards (``run_split``, the MoE FFN's experts).
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


def replicated(t, like, partial_dims=()) -> torch.Tensor:
    """A weight every shard needs whole (a plain tensor passes as it is).
    Its gradient is partial over every mesh dim on which ``like`` (the
    activation's local layout) is sharded, each shard having seen only its
    rows, and over ``partial_dims``."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate

    grad = tuple(Partial() if p.is_shard() or i in partial_dims else Replicate()
                 for i, p in enumerate(like))
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


def run_over_rows(fn, x, params, *state):
    """``fn(x, params, *state) -> (out, extra)`` run on ``x``'s batch
    shards: a block whose rows are independent (the xLSTM cells).  ``x``'s
    other dims and every weight are gathered whole (a weight's gradient is
    then partial over the shards); ``state`` leaves (batch first) take
    ``x``'s row shards.  ``out`` and the batch-first tensors of ``extra``
    come back with ``x``'s row placements."""
    rows = row_placements(x)
    xl = local(x, rows)
    pl = _tree(lambda t: replicated(t, rows), params)
    sl = _tree(lambda t: local(t, rows) if is_dtensor(t) else t, state)
    return _rows_back(x, rows, *fn(xl, pl, *sl), "rows")


def _rows_back(x, rows, out, more, extra: str):
    """A row-local block's results as DTensors on ``x``'s mesh: ``out``
    with ``x``'s row placements, and ``more`` as ``extra`` says:
    ``"rows"`` (batch-first tensors, placed like ``out``) or ``"means"``
    (token means of the shard: their mean over the shards, as a partial
    sum, is the whole batch's)."""
    from torch.distributed.tensor import Partial

    shards = 1
    for p, n in zip(rows, x.device_mesh.shape):
        shards *= n if p.is_shard() else 1
    out = wrap(out, x, rows, (x.shape[0],) + tuple(out.shape[1:]))
    if extra == "means":
        partial = tuple(Partial() if p.is_shard() else p for p in rows)
        more = _tree(lambda t: wrap(t / shards, x, partial, t.shape), more)
    else:
        more = _tree(lambda t: wrap(t, x, rows, (x.shape[0],) + tuple(t.shape[1:])),
                     more)
    return out, more


class _FirstOnly(torch.autograd.Function):
    """The identity, whose backward passes the gradient on where ``first``
    and zeros elsewhere."""

    @staticmethod
    def forward(ctx, t, first: bool):
        ctx.first = first
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


class Split:
    """One rank's share of a block that is local over batch rows and over
    one dim of some of its weights (``run_split``): ``offset`` and ``size``
    of this rank's slice of that dim, and ``dims``, the mesh dims that
    split it (none where the rules keep the dim whole)."""

    def __init__(self, x, rows, dims: tuple[int, ...], length: int):
        self._x, self._rows, self.dims = x, rows, dims
        mesh_shape, coord = x.device_mesh.shape, x.device_mesh.get_coordinate()
        index, parts = 0, 1
        for i in dims:  # the rules shard evenly, the first mesh dim outermost
            index, parts = index * mesh_shape[i] + coord[i], parts * mesh_shape[i]
        self.size = length // parts
        self.offset = index * self.size
        self._first = index == 0

    def once(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a value every rank of ``dims`` computes alike from the
        block's input or whole weights, whose gradient counts on the first
        of them only: those gradients are summed over ``dims``."""
        return _FirstOnly.apply(t, self._first) if self.dims else t

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ``dims`` of every rank's ``t`` (batch first, local
        rows): a ``Partial`` reduced to ``Replicate``.  Its gradient is the
        same on every rank."""
        if not self.dims:
            return t
        from torch.distributed.tensor import Partial

        partial = tuple(Partial() if i in self.dims else p
                        for i, p in enumerate(self._rows))
        whole = wrap(t, self._x, partial, (self._x.shape[0],) + tuple(t.shape[1:]))
        return local(whole, self._rows)


def run_split(fn, x, params, split: tuple[str, ...]):
    """``fn(x, params, part) -> (out, means)`` run on ``x``'s batch shards
    and, for the weights named in ``split``, on their shards of their first
    dim (the experts of an MoE FFN: ``fn`` computes its own slice,
    ``part``, and sums its share over ``part.dims`` with ``part.total``).
    Every other dim of those weights, and every other weight, is gathered
    whole.  ``x``'s gradient, and the whole weights', are partial over
    ``part.dims``: each rank's share of the slices, and the first rank's
    gradient of what all compute alike (``part.once``).  ``out`` comes back
    with ``x``'s row placements, ``means`` (token means of the shard) as a
    partial sum over the row shards."""
    from torch.distributed.tensor import Partial, Replicate

    rows = row_placements(x)
    kept = keep_shards(params[split[0]], (0,))
    dims = tuple(i for i, p in enumerate(kept) if p.is_shard())
    if any(rows[i].is_shard() for i in dims):
        raise ValueError(f"{split[0]!r} is split over a mesh dim that also "
                         f"splits the batch rows: {kept} against {rows}")
    part = Split(x, rows, dims, params[split[0]].shape[0])
    grad = tuple(p if i in dims else Partial() if rows[i].is_shard()
                 else Replicate() for i, p in enumerate(kept))
    pl = {name: local(t, kept, grad) if name in split else replicated(t, rows, dims)
          for name, t in params.items()}
    xgrad = tuple(Partial() if i in dims else p for i, p in enumerate(rows))
    xl = local(x, rows, xgrad if dims else None)
    return _rows_back(x, rows, *fn(xl, pl, part), "means")


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
