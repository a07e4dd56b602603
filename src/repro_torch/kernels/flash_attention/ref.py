"""Plain PyTorch versions of the flash-attention kernels.

* ``attention_reference`` (the JAX package's): full-materialisation softmax
  attention, causal and/or sliding-window, f32 accumulation;
* ``attention_lse_reference``: each query row's log-sum-exp, which the
  forward kernel writes beside its output for the backward;
* ``flash_backward_reference``: what the backward kernel computes, P
  rebuilt from that log-sum-exp and Delta from dO . O;
* ``attention_backward_reference``: the explicit gradient with P
  recomputed by a softmax, the independent oracle the tests and the card's
  checks hold the other two against.
"""

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


def _scaled(scores: torch.Tensor, D: int, scale: float | None) -> torch.Tensor:
    """Scores times ``scale``, or over sqrt(D) without one."""
    return scores / math.sqrt(D) if scale is None else scores * scale


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, H, Skv, D] (heads already matched);
    ``scale`` multiplies the scores (1 / sqrt(D) without one)."""
    D = q.shape[-1]
    scores = _scaled(torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()), D, scale)
    mask = visible(q.shape[2], k.shape[2], causal, window, q.device)
    scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def _grouped(t: torch.Tensor, kv: int) -> torch.Tensor:
    """[B, H, S, D] -> [B, KV, G, S, D] in f32 (query head h is group
    h % G of KV head h // G)."""
    B, H, S, D = t.shape
    return t.float().reshape(B, kv, H // kv, S, D)


def _scaled_scores(q: torch.Tensor, k: torch.Tensor,
                   scale: float | None = None) -> torch.Tensor:
    """[B, KV, G, Sq, Skv] f32 scores q.k / sqrt(D) (or times ``scale``),
    query heads grouped."""
    return _scaled(torch.einsum("bkgqd,bksd->bkgqs", _grouped(q, k.shape[1]),
                                k.float()), q.shape[-1], scale)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                            window: int = 0, scale: float | None = None) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, masked scores, f32
    [B, H, Sq] (natural log; +inf for a row that sees no key, so that
    exp(s - lse) = 0 there, as the forward writes 0 for such a row).

    q: [B, H, Sq, D]; k: [B, KV, Skv, D] with KV dividing H."""
    B, H, Sq, _D = q.shape
    mask = visible(Sq, k.shape[2], causal, window, q.device)
    scores = torch.where(mask, _scaled_scores(q, k, scale), -math.inf)
    lse = torch.logsumexp(scores, dim=-1)
    lse = torch.where(mask.any(dim=-1), lse, math.inf)
    return lse.reshape(B, H, Sq)


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, d_out: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             scale: float | None = None):
    """The gradient as the backward kernel computes it, in f32 inside.

    q, out, d_out: [B, H, Sq, D]; k, v: [B, KV, Skv, D] with KV dividing H;
    lse: [B, H, Sq] from the forward.  P = exp(q.k / sqrt(D) - lse) under
    the mask, Delta = rowsum(dO * O); then dV = P^T dO, dS = P * (dO V^T -
    Delta), dQ = dS K / sqrt(D) and dK = dS^T Q / sqrt(D), dK and dV summed
    over the query heads of a KV head (``scale`` in place of 1 / sqrt(D)
    where given).  Returns (dq, dk, dv) in the inputs' dtypes.
    """
    B, H, Sq, D = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    inv = 1.0 / math.sqrt(D) if scale is None else scale
    qf, of, dof = (_grouped(t, KV) for t in (q, out, d_out))
    kf, vf = k.float(), v.float()
    lse_g = lse.float().reshape(B, KV, H // KV, Sq, 1)
    mask = visible(Sq, Skv, causal, window, q.device)
    probs = torch.where(mask, torch.exp(_scaled_scores(q, k, scale) - lse_g), 0.0)
    dv = torch.einsum("bkgqs,bkgqd->bksd", probs, dof)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = probs * (dp - (dof * of).sum(dim=-1, keepdim=True))
    del dp, probs
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * inv
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * inv
    return (dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


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
    inv = 1.0 / math.sqrt(D)
    qf, of, dof = (_grouped(t, KV) for t in (q, out, d_out))
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
