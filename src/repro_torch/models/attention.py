"""Attention: GQA with RoPE, prefill through the flash kernel, KV-cache decode.

* ``attention`` — causal (optionally sliding-window) attention over a whole
  prompt; it calls the flash-attention entry point, which runs the CUDA
  kernel on CUDA tensors and the plain version on CPU tensors;
* ``decode_attention`` — one new token against a cache with a length per
  batch row, in plain PyTorch (the JAX package has no kernel there);
* ``latent_decode_attention`` — the same for latent attention (MLA): one
  token's absorbed queries against the cached latents and RoPE keys;
* ``yarn_inv_freq``, ``yarn_softmax_scale`` and ``apply_rope_pairs`` — the
  YaRN-scaled RoPE of DeepSeek-V2, which rotates consecutive pairs.

Shapes follow the JAX package's [B, S, H, D] convention at these functions.
"""

from __future__ import annotations

import functools
import math

import torch

import torch.nn.functional as F

from repro_torch.kernels._shard import is_dtensor
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

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


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, theta: float, scaling: dict, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies of a ``dim``-wide RoPE (arXiv:2309.00071,
    as DeepSeek-V2 computes them): each frequency a blend of the plain one
    and the plain one over ``factor``, interpolated below the dimension
    that turns ``beta_slow`` times over ``original_max_position_embeddings``
    positions and extrapolated above the one that turns ``beta_fast`` times,
    with a linear ramp between (the bounds floored and ceiled)."""
    factor = scaling["factor"]
    original = scaling["original_max_position_embeddings"]

    def correction_dim(turns: float) -> float:
        return dim * math.log(original / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(scaling["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(scaling["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    extra = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device)
                        - low) / (high - low), 0, 1)
    return extra / factor * ramp + extra * (1 - ramp)


def yarn_softmax_scale(head_dim: int, scaling: dict | None) -> float:
    """The softmax scale of a YaRN latent-attention model: head_dim^-1/2
    times m^2 with m = 0.1 mscale_all_dim ln(factor) + 1 (DeepSeek-V2's
    ``softmax_scale``); head_dim^-1/2 without scaling."""
    scale = head_dim ** -0.5
    if scaling is not None and scaling.get("mscale_all_dim"):
        m = _yarn_mscale(scaling["factor"], scaling["mscale_all_dim"])
        scale *= m * m
    return scale


@functools.lru_cache(maxsize=8)
def _pairs_inv_freq(dim: int, theta: float, scaling: tuple | None, device: str):
    """The inverse frequencies and YaRN's attention factor, made once a
    configuration and device (``scaling`` as sorted items)."""
    with torch.inference_mode(False), torch.no_grad():
        if scaling is None:
            return rope_frequencies(dim, theta, device), 1.0
        rs = dict(scaling)
        att = (_yarn_mscale(rs["factor"], rs.get("mscale") or 1.0)
               / _yarn_mscale(rs["factor"], rs.get("mscale_all_dim") or 1.0))
        return yarn_inv_freq(dim, theta, rs, device), att


def rope_pairs_turns(dim: int, theta: float, scaling: dict | None,
                     positions: torch.Tensor) -> torch.Tensor:
    """Complex64 [..., dim / 2] at ``positions`` ([S] or [B, S]) for
    ``apply_rope_pairs``: pair i turns by position times frequency i (YaRN's
    where ``scaling`` is given), its length YaRN's attention factor
    mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""
    key = None if scaling is None else tuple(sorted(scaling.items()))
    inv, att = _pairs_inv_freq(dim, theta, key, str(positions.device))
    angles = positions[..., None].float() * inv
    return torch.polar(torch.full_like(angles, att), angles)


def apply_rope_pairs(x: torch.Tensor, turn: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D] rotated in consecutive pairs (x[2i], x[2i+1]) by
    ``turn`` [S, D/2] or [B, S, D/2] (``rope_pairs_turns``), as DeepSeek's
    code does, computed as complex products in f32."""
    if turn.dim() == 2:
        turn = turn[None]
    z = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)))
    return torch.view_as_real(z * turn[:, :, None]).flatten(-2).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: float | None = None) -> torch.Tensor:
    """q: [B, S, H, D]; k, v: [B, S, KV, D] -> [B, S, H, D].

    Positions count from 0 for queries and keys.  The transposes are views:
    the kernel takes strides, so no copy is made.  ``scale`` multiplies the
    scores (1 / sqrt(D) without one).
    """
    out = flash_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=scale)
    return out.transpose(1, 2)


def padded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """Causal attention whose query/key width differs from the value's
    (latent attention's 192 and 128): q, k [B, S, H, Dqk] and v [B, S, H,
    Dv] zero-padded to the least head dim the flash kernel has that holds
    both, which leaves every q.k and every kept output column as it was;
    the output cut back to [B, S, H, Dv]."""
    dv = v.shape[-1]
    width = next(d for d in HEAD_DIMS if d >= max(q.shape[-1], dv))
    q, k, v = (F.pad(t, (0, width - t.shape[-1])) for t in (q, k, v))
    return attention(q, k, v, causal=True, scale=scale)[..., :dv]


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


def latent_decode_attention(q_lat: torch.Tensor, q_pe: torch.Tensor,
                            cache_c: torch.Tensor, cache_pe: torch.Tensor,
                            cache_len, scale: float) -> torch.Tensor:
    """Absorbed latent attention of one token a row, in float32.

    q_lat: [B, 1, H, R], each head's no-RoPE query already multiplied into
    the latent space; q_pe: [B, 1, H, P], the RoPE queries; cache_c: [B,
    Skv, R] the normed latents; cache_pe: [B, Skv, P] the RoPE keys shared
    by the heads; cache_len: int or [B].  Scores (q_lat . c + q_pe . k_pe)
    * scale over each row's first ``cache_len`` positions; returns the
    softmax-weighted latents [B, 1, H, R] (f32), which the caller
    multiplies by the value up-projection.
    """
    Skv = cache_c.shape[1]
    c = cache_c.float()
    scores = (torch.einsum("bhr,bsr->bhs", q_lat[:, 0].float(), c)
              + torch.einsum("bhp,bsp->bhs", q_pe[:, 0].float(), cache_pe.float())) * scale
    kv_pos = torch.arange(Skv, device=q_lat.device)
    lens = torch.as_tensor(cache_len, device=q_lat.device).reshape(-1, 1)
    valid = kv_pos[None] < lens  # [B, Skv]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bsr->bhr", probs, c)[:, None]
