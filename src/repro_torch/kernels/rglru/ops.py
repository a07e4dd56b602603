"""Public RG-LRU scan entry point: the tensors' device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or raises.  Nothing falls back from one to the other.  The kernel
masks a ragged W itself, so no padding is needed (the JAX package's
``ops.rglru_scan`` pads W to its 128-lane blocks).

Where a gradient is wanted, the call goes through ``RGLRUScanFunction``: its
backward is the adjoint recurrence.  On CPU tensors that is the plain
version, ``ref.rglru_scan_backward`` over the sequential scan run on
reversed inputs; on CUDA tensors the backward kernel
(``kernel.rglru_scan_backward_cuda``, one launch), which computes the same
construction over the chunked scan bit for bit without reversing anything.
Without autograd (serving), the scan is called directly.

The scan and its backward are ``torch.library`` custom ops
(``repro_torch::rglru_scan``, ``repro_torch::rglru_scan_backward``) with
fake impls (shapes and dtypes only), so a fake-tensor trace passes through
them without a launch.  A DTensor never reaches them: the recurrent block
calls them on local shards (the scan is elementwise over ``rnn_state``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _shard
from repro_torch.kernels.rglru.kernel import rglru_scan_backward_cuda, rglru_scan_cuda
from repro_torch.kernels.rglru.ref import rglru_scan_backward, rglru_scan_reference


def _scan_impl(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    tensors = (a, b) if h0 is None else (a, b, h0)
    if all(t.device.type == "cpu" for t in tensors):
        h, h_last = rglru_scan_reference(a, b, h0)
        # an op's outputs never alias its inputs (S = 0 gives h0 back)
        return h, h_last.clone() if h_last is h0 else h_last
    return rglru_scan_cuda(a.contiguous(), b.contiguous(),
                           None if h0 is None else h0.contiguous())


# Run on CPU and CUDA tensors; a fake or meta tensor takes the fake impl.
_scan = torch.library.custom_op("repro_torch::rglru_scan", _scan_impl,
                                mutates_args=())


@_scan.register_fake
def _scan_fake(a, b, h0=None):
    return (torch.empty_like(a, memory_format=torch.contiguous_format),
            a.new_empty((a.shape[0], a.shape[2]), dtype=torch.float32))


def _scan_backward_impl(a: torch.Tensor, h: torch.Tensor,
                        h0: torch.Tensor | None, gh: torch.Tensor,
                        g_last: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(da, db, dh0) in f32 (dh0 in h0's type; empty without h0)."""
    if a.device.type == "cpu":
        da, db, dh0 = rglru_scan_backward(a, h, h0, gh, g_last,
                                          rglru_scan_reference)
    else:
        da, db, dh0 = rglru_scan_backward_cuda(
            a.contiguous(), h.contiguous(), None if h0 is None else h0.contiguous(),
            gh.contiguous(), g_last.float().contiguous())
    return da, db, a.new_empty((0,)) if dh0 is None else dh0


_scan_backward = torch.library.custom_op("repro_torch::rglru_scan_backward",
                                        _scan_backward_impl, mutates_args=())


@_scan_backward.register_fake
def _scan_backward_fake(a, h, h0, gh, g_last):
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    return (torch.empty_like(a, **f32), torch.empty_like(a, **f32),
            a.new_empty((0,)) if h0 is None else torch.empty_like(h0))


class RGLRUScanFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = _scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.b_dtype = b.dtype
        return h, h_last

    @staticmethod
    def backward(ctx, gh, g_last):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = _scan_backward(a, h, h0, gh, g_last)
        return da.to(a.dtype), db.to(ctx.b_dtype), None if h0 is None else dh0


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None):
    """a, b: [B, S, W]; h0: [B, W] or None.  Returns (h [B, S, W] in
    ``a.dtype``, h_last [B, W] in float32).  DTensors scan shard by shard
    over batch and width (S gathered)."""
    if _shard.is_dtensor(a, b, h0):
        from torch.distributed.tensor import Shard

        placements = _shard.keep_shards(a, (0, 2))
        state = tuple(Shard(1) if p.is_shard() and p.dim == 2 else p
                      for p in placements)
        h, h_last = rglru_scan(
            _shard.local(a, placements), _shard.local(b, placements),
            None if h0 is None else _shard.local(h0, state))
        B, _S, W = a.shape
        return (_shard.wrap(h, a, placements, a.shape),
                _shard.wrap(h_last, a, state, (B, W)))
    tensors = (a, b) if h0 is None else (a, b, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return RGLRUScanFunction.apply(a, b, h0)
    return _scan(a, b, h0)
