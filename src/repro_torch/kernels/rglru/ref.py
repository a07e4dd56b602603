"""Plain PyTorch versions of the RG-LRU scan: the JAX package's
``rglru_scan_reference``, the sequential recurrence
``h_t = a_t * h_{t-1} + b_t`` with a float32 carry; and
``rglru_scan_chunked``, the CUDA kernel's order of operations."""

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


def rglru_scan_chunked(a: torch.Tensor, b: torch.Tensor,
                       h0: torch.Tensor | None, chunk: int):
    """The scan as the CUDA kernel computes it, with chunks of ``chunk``
    steps: each chunk's (A = prod a, l = the scan from 0); the state carried
    across chunks in order, h_in(c) = A(c-1) * h_in(c-1) + l(c-1); each chunk
    rescanned from h_in.  Every product and sum is rounded on its own, so the
    kernel equals this bit for bit at its plan's chunk length; with one chunk
    (S <= chunk) it is ``rglru_scan_reference``.  Same arguments and results.
    """
    B, S, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    if S == 0:
        return torch.empty_like(a), h
    C = -(-S // chunk)
    # Pad to C whole chunks with steps a = 1, b = 0, which leave A, l and h
    # as they are.
    pad = C * chunk - S
    af = torch.cat([a.float(), a.new_ones((B, pad, W), dtype=torch.float32)], 1)
    bf = torch.cat([b.float(), b.new_zeros((B, pad, W), dtype=torch.float32)], 1)
    af = af.view(B, C, chunk, W)
    bf = bf.view(B, C, chunk, W)
    A = torch.ones((B, C, W), dtype=torch.float32, device=a.device)
    l = torch.zeros((B, C, W), dtype=torch.float32, device=a.device)
    for k in range(chunk):
        A = A * af[:, :, k]
        l = af[:, :, k] * l + bf[:, :, k]
    h_in = [h]
    for c in range(C - 1):
        h = A[:, c] * h + l[:, c]
        h_in.append(h)
    h = torch.stack(h_in, 1)
    hs = torch.empty((B, C, chunk, W), dtype=torch.float32, device=a.device)
    for k in range(chunk):
        h = af[:, :, k] * h + bf[:, :, k]
        hs[:, :, k] = h
    hs = hs.view(B, C * chunk, W)
    return hs[:, :S].to(a.dtype), hs[:, S - 1].clone()
