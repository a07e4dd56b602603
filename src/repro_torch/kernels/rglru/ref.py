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


def _h_prev(h: torch.Tensor, h0: torch.Tensor | None) -> torch.Tensor:
    """h_{t-1} for every t in f32: h0 (or zeros), then h_0 .. h_{S-2}."""
    B, _S, W = h.shape
    first = (torch.zeros((B, 1, W), dtype=torch.float32, device=h.device)
             if h0 is None else h0.float()[:, None])
    return torch.cat([first, h[:, :-1].float()], dim=1)


def _grads(a, h, h0, g):
    """(da, db, dh0) from the state gradient g [B, S, W] (f32)."""
    da = g * _h_prev(h, h0)
    dh0 = None if h0 is None else (a[:, 0].float() * g[:, 0]).to(h0.dtype)
    return da, g, dh0


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor,
                        h0: torch.Tensor | None, gh: torch.Tensor,
                        g_last: torch.Tensor, scan):
    """Gradient of the scan h_t = a_t * h_{t-1} + b_t at (a, h0), given every
    h it produced, for upstream gradients ``gh`` (of h) and ``g_last`` (of
    h_last).  The adjoint is the same recurrence run backwards,

        g_t = gh_t + a_{t+1} * g_{t+1},  g_{S-1} = gh_{S-1} + g_last,

    which is ``scan`` itself on reversed inputs: the coefficients
    a_1 .. a_{S-1}, 1 and the inputs gh, reversed, from h0 = g_last.  Then
    db = g, da_t = g_t * h_{t-1} and dh0 = a_0 * g_0.  Returns (da, db, dh0)
    in f32 (dh0 in h0's type, or None), the dtypes of a and b left to the
    caller.
    """
    B, S, W = a.shape
    if S == 0:
        return torch.zeros_like(a, dtype=torch.float32), \
            torch.zeros_like(a, dtype=torch.float32), \
            None if h0 is None else torch.zeros_like(h0)
    coeff = torch.cat([a[:, 1:].float(),
                       torch.ones((B, 1, W), dtype=torch.float32, device=a.device)],
                      dim=1)
    g_rev, _ = scan(coeff.flip(1).contiguous(), gh.float().flip(1).contiguous(),
                    g_last.float().contiguous())
    return _grads(a, h, h0, g_rev.flip(1).float())


def rglru_scan_backward_reference(a: torch.Tensor, h: torch.Tensor,
                                  h0: torch.Tensor | None, gh: torch.Tensor,
                                  g_last: torch.Tensor):
    """The same gradient as an explicit sequential loop from t = S-1 down to
    0, each step a product then a sum, each rounded."""
    B, S, W = a.shape
    g = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    carry = g_last.float()
    for t in range(S - 1, -1, -1):
        carry = gh[:, t].float() + (a[:, t + 1].float() * carry if t + 1 < S
                                    else carry)
        g[:, t] = carry
    return _grads(a, h, h0, g)
