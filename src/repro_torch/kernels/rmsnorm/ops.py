"""Public RMS-norm entry point: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version; a CUDA tensor takes the CUDA
kernel, or raises.  Nothing falls back from one to the other.  The kernel
takes any number of rows, so no padding is needed.

Where a gradient is wanted, the call goes through ``RMSNormFunction``: its
forward is the path above, and its backward the explicit gradient, as the
plain version (``rms_norm_backward_reference``) on CPU tensors and as the
CUDA backward kernel on CUDA tensors.  Without autograd (serving), the
forward is called directly and records nothing.

Both directions are ``torch.library`` custom ops (``repro_torch::rms_norm``
and ``repro_torch::rms_norm_backward``) with fake impls that give only
shapes and dtypes, so a fake-tensor trace (the dry-run) passes through
them without arithmetic and without a launch.  A DTensor never reaches
them: the model calls them on local shards (``core/channels.local_call``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _shard
from repro_torch.kernels.rmsnorm.kernel import rms_norm_bwd_cuda, rms_norm_cuda
from repro_torch.kernels.rmsnorm.ref import (
    rms_norm_backward_reference,
    rms_norm_reference,
)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _forward_impl(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if _on_cpu(x, scale):
        return rms_norm_reference(x, scale, eps)
    rows = x.reshape(-1, x.shape[-1])
    return rms_norm_cuda(rows.contiguous(), scale.contiguous(), eps).reshape(x.shape)


# The op runs this on CPU and CUDA tensors; a fake or meta tensor takes
# the fake impl.
_forward = torch.library.custom_op("repro_torch::rms_norm", _forward_impl,
                                   mutates_args=())


@_forward.register_fake
def _forward_fake(x, scale, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _backward_impl(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                   eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient at (x, scale) for the upstream gradient ``g``: (dx in
    ``x.dtype``, dscale in ``scale.dtype``)."""
    if _on_cpu(x, scale, g):
        return rms_norm_backward_reference(x, scale, g, eps)
    D = x.shape[-1]
    dx, dscale = rms_norm_bwd_cuda(
        x.reshape(-1, D).contiguous(), scale.contiguous(),
        g.reshape(-1, D).contiguous().to(x.dtype), eps)
    return dx.reshape(x.shape), dscale


_backward = torch.library.custom_op("repro_torch::rms_norm_backward",
                                    _backward_impl, mutates_args=())


@_backward.register_fake
def _backward_fake(x, scale, g, eps):
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            torch.empty_like(scale))


class RMSNormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = _backward(x, scale, g, ctx.eps)
        return dx, dscale, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D].  Normalised rows in ``x.dtype``.  A DTensor
    ``x`` is normalised shard by shard (rows stay where they are, D whole)."""
    if _shard.is_dtensor(x, scale):
        placements = _shard.keep_shards(x, range(x.ndim - 1))
        out = rms_norm(_shard.local(x, placements),
                       _shard.replicated(scale, placements), eps)
        return _shard.wrap(out, x, placements, x.shape)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFunction.apply(x, scale, eps)
    return _forward(x, scale, eps)
