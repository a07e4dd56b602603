"""Public flash-attention entry point: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version (K/V repeated to the query
heads, as the JAX package's ``ops`` does); a CUDA tensor takes the CUDA
kernel, which reads KV head ``h // (H / KV)`` in place, or raises.  Nothing
falls back from one to the other.  The kernel masks ragged Sq and Skv
itself, so no padding is needed.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_reference


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, KV, Skv, D] (KV divides H: GQA)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        H, KV = q.shape[1], k.shape[1]
        if H % KV:
            raise ValueError(f"H={H} not a multiple of KV={KV}")
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
        return attention_reference(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
