"""Plain PyTorch version of the RG-LRU scan (the JAX package's
``rglru_scan_reference``): the sequential recurrence
``h_t = a_t * h_{t-1} + b_t`` with a float32 carry."""

from __future__ import annotations

import torch


def rglru_scan_reference(a: torch.Tensor, b: torch.Tensor,
                         h0: torch.Tensor | None = None):
    """a, b: [B, S, W]; h0: [B, W] or None (zeros).

    Returns (every h in ``a.dtype`` [B, S, W], the last h in float32
    [B, W]).  Each step is a product, then a sum, each rounded.
    """
    B, S, W = a.shape
    if h0 is None:
        h = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    else:
        h = h0.float()
    hs = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        hs[:, t] = h
    return hs, h
