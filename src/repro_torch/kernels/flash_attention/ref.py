"""Plain PyTorch version of the flash-attention kernel (the JAX package's
``attention_reference``): full-materialisation softmax attention, causal
and/or sliding-window, f32 accumulation."""

from __future__ import annotations

import math

import torch


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, H, Skv, D] (heads already matched)."""
    D = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    Sq, Skv = q.shape[2], k.shape[2]
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)
