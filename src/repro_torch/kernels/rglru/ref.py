"""Plain PyTorch versions of the RG-LRU scan: the JAX package's
``rglru_scan_reference``, the sequential recurrence
``h_t = a_t * h_{t-1} + b_t`` with a float32 carry; and
``rglru_scan_chunked``, the CUDA kernel's order of operations.  Of its
gradient: ``rglru_scan_backward`` (the adjoint as a scan on reversed
inputs), ``rglru_scan_backward_chunked`` (the backward kernel's order) and
``rglru_scan_backward_reference`` (an explicit reverse loop)."""

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

    Over ``rglru_scan_reference`` this is the CPU path's gradient; over
    ``rglru_scan_chunked`` at ``kernel.chunk_plan(S, W).length`` it is the
    plain version of what the card computes: the backward kernel
    (``csrc/rglru_bwd.cu``) equals it bit for bit, as does
    ``rglru_scan_backward_chunked``, which takes the kernel's order without
    reversing any tensor.
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


def rglru_scan_backward_chunked(a: torch.Tensor, h: torch.Tensor,
                                h0: torch.Tensor | None, gh: torch.Tensor,
                                g_last: torch.Tensor, chunk: int):
    """The gradient as the backward kernel computes it, with chunks of
    ``chunk`` steps counted from the end of S: reversed chunk k holds the
    steps t = S-1-k*chunk down to max(0, S-(k+1)*chunk), each with the
    coefficient a_{t+1} (1 at t = S-1) and the input gh_t.  Each chunk's
    (A = prod of its coefficients, l = its reverse scan from 0); g carried
    across chunks in reversed order from g_last, g_in(k) = A(k-1) *
    g_in(k-1) + l(k-1); each chunk rescanned from g_in.  Every product and
    sum is rounded on its own, in the order of ``rglru_scan_backward`` over
    ``rglru_scan_chunked`` at the same chunk, so the two are equal bit for
    bit.  Same arguments (and ``chunk``) and results as
    ``rglru_scan_backward``."""
    B, S, W = a.shape
    if S == 0:
        return torch.zeros_like(a, dtype=torch.float32), \
            torch.zeros_like(a, dtype=torch.float32), \
            None if h0 is None else torch.zeros_like(h0)
    C = -(-S // chunk)
    # Step k of reversed chunk c is t = S-1-(c*chunk + k); t < 0 pads the last
    # chunk with coefficients 1 and inputs 0, past t = 0: they change neither
    # any g_t nor a carried pair (the last chunk's pair is never carried).
    t = S - 1 - torch.arange(C * chunk, device=a.device).view(C, chunk)
    af, gf = a.float(), gh.float()
    coeff = torch.where(((t >= 0) & (t + 1 < S))[..., None],
                        af[:, (t + 1).clamp(0, S - 1)], 1.0)
    x = torch.where((t >= 0)[..., None], gf[:, t.clamp(min=0)], 0.0)
    A = torch.ones((B, C, W), dtype=torch.float32, device=a.device)
    l = torch.zeros((B, C, W), dtype=torch.float32, device=a.device)
    for k in range(chunk):
        A = A * coeff[:, :, k]
        l = coeff[:, :, k] * l + x[:, :, k]
    g = g_last.float()
    g_in = [g]
    for c in range(C - 1):
        g = A[:, c] * g + l[:, c]
        g_in.append(g)
    g = torch.stack(g_in, 1)
    gs = torch.empty((B, C, chunk, W), dtype=torch.float32, device=a.device)
    for k in range(chunk):
        g = coeff[:, :, k] * g + x[:, :, k]
        gs[:, :, k] = g
    # Reversed step s = S-1-t holds g_t.
    s = S - 1 - torch.arange(S, device=a.device)
    return _grads(a, h, h0, gs.view(B, C * chunk, W)[:, s])


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
