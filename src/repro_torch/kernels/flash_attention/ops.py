"""Public flash-attention entry point: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version (K/V repeated to the query
heads, as the JAX package's ``ops`` does); a CUDA tensor takes the CUDA
kernel, which reads KV head ``h // (H / KV)`` in place, or raises.  Nothing
falls back from one to the other.  The kernel masks ragged Sq and Skv
itself, so no padding is needed.

Where a gradient is wanted, the call goes through
``FlashAttentionFunction``: its forward also returns each query row's
log-sum-exp (the plain ``attention_lse_reference`` on CPU tensors, the
forward kernel's extra output on CUDA ones), and its backward rebuilds P
from it: ``flash_backward_reference`` on CPU tensors, the backward kernel
(``flash_attention_backward_cuda``) on CUDA ones.  Without autograd
(serving), the forward is called directly and writes no log-sum-exp.

The three are ``torch.library`` custom ops (``repro_torch::flash_attention``,
``repro_torch::flash_attention_lse``, ``repro_torch::flash_attention_backward``)
with fake impls (shapes and dtypes only) and FLOP formulas, so a
fake-tensor trace (the dry-run) passes through them without arithmetic or
a launch and ``FlopCounterMode``'s registry counts them as attention and
its gradient.  A DTensor never reaches them: the model calls them on local
shards.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _shard
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_cuda,
    flash_attention_cuda,
    tma_layout_error,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_lse_reference,
    attention_reference,
    flash_backward_reference,
)


def _forward_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int, scale: float | None = None) -> torch.Tensor:
    if all(t.device.type == "cpu" for t in (q, k, v)):
        H, KV = q.shape[1], k.shape[1]
        if H % KV:
            raise ValueError(f"H={H} not a multiple of KV={KV}")
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
        return attention_reference(q, k, v, causal=causal, window=window, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)


# Run on CPU and CUDA tensors; a fake or meta tensor takes the fake impl.
_forward = torch.library.custom_op("repro_torch::flash_attention",
                                   _forward_impl, mutates_args=())


@_forward.register_fake
def _forward_fake(q, k, v, causal, window, scale=None):
    return torch.empty_like(q)


def _flash_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    """QK^T and PV over every (query, key) pair, as the library counts
    ``scaled_dot_product_attention`` (the causal mask is not subtracted)."""
    B, H, Sq, D = q_shape
    Skv = k_shape[2]
    return 4 * B * H * Sq * Skv * D


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _forward_lse_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                      window: int, scale: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the forward and each query row's log-sum-exp, f32
    [B, H, Sq]."""
    if _on_cpu(q, k, v):
        return (_forward_impl(q, k, v, causal, window, scale),
                attention_lse_reference(q, k, causal=causal, window=window, scale=scale))
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, lse=lse,
                                scale=scale), lse


_forward_lse = torch.library.custom_op("repro_torch::flash_attention_lse",
                                       _forward_lse_impl, mutates_args=())


@_forward_lse.register_fake
def _forward_lse_fake(q, k, v, causal, window, scale=None):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


register_flop_formula([torch.ops.repro_torch.flash_attention,
                       torch.ops.repro_torch.flash_attention_lse])(_flash_flops)


def _backward_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   d_out: torch.Tensor, lse: torch.Tensor, causal: bool,
                   window: int, scale: float | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the dtypes of q, k and v."""
    if _on_cpu(q, k, v, out, d_out, lse):
        return flash_backward_reference(q, k, v, out, d_out, lse, causal=causal,
                                        window=window, scale=scale)
    return flash_attention_backward_cuda(q, k, v, out, d_out, lse, causal=causal,
                                         window=window, scale=scale)


_backward = torch.library.custom_op("repro_torch::flash_attention_backward",
                                    _backward_impl, mutates_args=())


@_backward.register_fake
def _backward_fake(q, k, v, out, d_out, lse, causal, window, scale=None):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _flash_backward_flops(q_shape, k_shape, *args, **kwargs) -> int:
    """Five products over every (query, key) pair (S, dP, dV, dQ and dK),
    as the library counts SDPA's backward (``sdpa_backward_flop_count``)."""
    B, H, Sq, D = q_shape
    Skv = k_shape[2]
    return 10 * B * H * Sq * Skv * D


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """The incoming gradient as the backward kernel reads it: autograd picks
    its layout (it can be expanded, or strided off the 16-byte rule), so
    one the kernel cannot read in place is made contiguous.  The base's
    alignment is judged from its offset in its allocation (allocations are
    aligned far beyond 16 bytes), so a fake tensor, which has no address,
    is judged too."""
    if t.device.type == "cpu":
        return t
    offset = t.storage_offset() * t.element_size()
    if t.stride(-1) == 1 and (t.dtype != torch.bfloat16 or tma_layout_error(
            t.shape, t.stride(), t.dtype, offset) is None):
        return t
    return t.contiguous()


class FlashAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale=None):
        out, lse = _forward_lse(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, _tma_ready(d_out), lse, ctx.causal,
                               ctx.window, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, KV, Skv, D] (KV divides H: GQA).
    ``scale`` multiplies the scores (1 / sqrt(D) without one).

    DTensors run shard by shard over batch and heads: q keeps those shards
    (its sequence and head_dim gathered), and k and v take q's placements,
    so each shard's KV heads are its query heads' groups (the caller
    expands KV heads the model axis does not divide)."""
    if _shard.is_dtensor(q, k, v):
        placements = _shard.keep_shards(q, (0, 1))
        out = flash_attention(*(_shard.local(t, placements) for t in (q, k, v)),
                              causal=causal, window=window, scale=scale)
        return _shard.wrap(out, q, placements, q.shape)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)
