"""Public flash-attention entry point: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version (K/V repeated to the query
heads, as the JAX package's ``ops`` does); a CUDA tensor takes the CUDA
kernel, which reads KV head ``h // (H / KV)`` in place, or raises.  Nothing
falls back from one to the other.  The kernel masks ragged Sq and Skv
itself, so no padding is needed.

Where a gradient is wanted, the call goes through
``FlashAttentionFunction``: its forward is the path above and its backward
the explicit gradient ``attention_backward_reference`` in PyTorch on either
device (P recomputed under the mask).  A hand-written backward kernel is
queued work (ROADMAP queue 2).  Without autograd (serving), the forward is
called directly.

The forward is a ``torch.library`` custom op, ``repro_torch::flash_attention``,
with a fake impl (shapes and dtypes only) and a FLOP formula, so a
fake-tensor trace (the dry-run) passes through it without arithmetic or a
launch and ``FlopCounterMode``'s registry counts it as attention.  A
DTensor never reaches it: the model calls it on local shards.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _shard
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference,
    attention_reference,
)


def _forward_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int) -> torch.Tensor:
    if all(t.device.type == "cpu" for t in (q, k, v)):
        H, KV = q.shape[1], k.shape[1]
        if H % KV:
            raise ValueError(f"H={H} not a multiple of KV={KV}")
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
        return attention_reference(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


# Run on CPU and CUDA tensors; a fake or meta tensor takes the fake impl.
_forward = torch.library.custom_op("repro_torch::flash_attention",
                                   _forward_impl, mutates_args=())


@_forward.register_fake
def _forward_fake(q, k, v, causal, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    """QK^T and PV over every (query, key) pair, as the library counts
    ``scaled_dot_product_attention`` (the causal mask is not subtracted)."""
    B, H, Sq, D = q_shape
    Skv = k_shape[2]
    return 4 * B * H * Sq * Skv * D


class FlashAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = attention_backward_reference(
            q, k, v, out, d_out, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, KV, Skv, D] (KV divides H: GQA).

    DTensors run shard by shard over batch and heads: q keeps those shards
    (its sequence and head_dim gathered), and k and v take q's placements,
    so each shard's KV heads are its query heads' groups (the caller
    expands KV heads the model axis does not divide)."""
    if _shard.is_dtensor(q, k, v):
        placements = _shard.keep_shards(q, (0, 1))
        out = flash_attention(*(_shard.local(t, placements) for t in (q, k, v)),
                              causal=causal, window=window)
        return _shard.wrap(out, q, placements, q.shape)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)
