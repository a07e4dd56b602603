"""Plain PyTorch version of the flash-attention kernel (the JAX package's
``attention_reference``): full-materialisation softmax attention, causal
and/or sliding-window, f32 accumulation; and the explicit gradient of the
same function (``attention_backward_reference``)."""

from __future__ import annotations

import math

import torch


def visible(sq: int, skv: int, causal: bool, window: int, device) -> torch.Tensor:
    """[Sq, Skv] mask of the keys each query attends to."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, H, Skv, D] (heads already matched)."""
    D = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    mask = visible(q.shape[2], k.shape[2], causal, window, q.device)
    scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 d_out: torch.Tensor, *, causal: bool = True,
                                 window: int = 0):
    """Explicit gradient of attention, in f32 inside.

    q, out, d_out: [B, H, Sq, D]; k, v: [B, KV, Skv, D] with KV dividing H
    (query head h reads KV head h // (H / KV)).  P is recomputed under the
    mask, then dV = P^T dO, dS = P * (dO V^T - rowsum(dO * O)),
    dQ = dS K / sqrt(D) and dK = dS^T Q / sqrt(D); dK and dV sum over the
    query heads that share a KV head.  Returns (dq, dk, dv) in the inputs'
    dtypes.
    """
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    inv = 1.0 / math.sqrt(D)

    def grouped(t):  # [B, H, S, D] -> [B, KV, G, S, D] in f32
        return t.float().reshape(B, KV, G, t.shape[2], D)

    qf, of, dof = grouped(q), grouped(out), grouped(d_out)
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) / math.sqrt(D)
    mask = visible(Sq, Skv, causal, window, q.device)
    probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    del scores
    dv = torch.einsum("bkgqs,bkgqd->bksd", probs, dof)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = probs * (dp - (dof * of).sum(dim=-1, keepdim=True))
    del dp, probs
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * inv
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * inv
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
