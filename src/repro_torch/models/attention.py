"""Attention: GQA with RoPE, prefill through the flash kernel, KV-cache decode.

* ``attention`` — causal (optionally sliding-window) attention over a whole
  prompt; it calls the flash-attention entry point, which runs the CUDA
  kernel on CUDA tensors and the plain version on CPU tensors;
* ``decode_attention`` — one new token against a cache with a length per
  batch row, in plain PyTorch (the JAX package has no kernel there).

Shapes follow the JAX package's [B, S, H, D] convention at these functions.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels._shard import is_dtensor
from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] or [S]."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # [half]
    angles = positions[..., None].float() * freqs  # [B?, S, half]
    if angles.dim() == 2:  # [S, half] -> broadcast over batch
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]  # [B, S, 1, half]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, S, H, D]; k, v: [B, S, KV, D] -> [B, S, H, D].

    Positions count from 0 for queries and keys.  The transposes are views:
    the kernel takes strides, so no copy is made.
    """
    out = flash_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len) -> torch.Tensor:
    """q: [B, 1, H, D]; cache_k/v: [B, Skv, KV, D]; cache_len: int or [B].

    Cache row b attends to its first ``cache_len[b]`` positions.
    """
    B, _, H, D = q.shape
    Skv, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    if is_dtensor(q):
        # the q heads are grouped by KV head: a head shard that is not a
        # whole number of groups takes the (one-token) q whole
        from torch.distributed.tensor import Replicate

        sizes = q.device_mesh.shape
        placements = tuple(
            Replicate() if p.is_shard() and p.dim == 2 and KV % n else p
            for p, n in zip(q.placements, sizes))
        if placements != tuple(q.placements):
            q = q.redistribute(q.device_mesh, placements)
    qg = q.reshape(B, KV, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          cache_k.float()) / math.sqrt(D)
    kv_pos = torch.arange(Skv, device=q.device)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = kv_pos[None] < lens  # [B, Skv]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cache_v.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
