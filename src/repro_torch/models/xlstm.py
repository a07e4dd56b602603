"""xLSTM blocks (arXiv:2405.04517), the JAX package's ``models/xlstm.py``:
mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar memory with
memory mixing, sequential scan).

mLSTM recurrence per head (head dim ``d``)::

    C_t = f_t C_{t-1} + i_t v_t k_t^T          (matrix memory, d x d)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

with exponential input gate ``i = exp(itilde)``, forget gate
``f = sigmoid/exp`` and the max-stabiliser ``m_t``.  A prompt runs the
chunkwise-parallel form (intra-chunk quadratic + inter-chunk state), a
decode step the recurrence with O(1) state.  Each function follows its JAX
counterpart op by op.  The JAX package has no Pallas kernel here: these
are plain PyTorch on either device.

The chunkwise form takes any S: a last chunk shorter than ``chunk`` runs
the same step at its own length.  The JAX function refuses an S that
``chunk`` does not divide, which a prompt longer than 64 tokens usually is.

sLSTM is sequential over S: one step of a few launches per token.  The
four recurrent products of a step are one batched product over the heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, fan_in_normal
from repro_torch.models.recurrent import causal_conv1d

# ---------------------------------------------------------------------------
# mLSTM core
# ---------------------------------------------------------------------------


def _initial_mlstm(B, H, D, device):
    return (torch.zeros((B, H, D, D), dtype=torch.float32, device=device),
            torch.zeros((B, H, D), dtype=torch.float32, device=device),
            torch.full((B, H), -math.inf, dtype=torch.float32, device=device))


def mlstm_sequential(q, k, v, i_raw, f_raw, initial=None):
    """Oracle: step the recurrence. q/k/v: [B, S, H, D]; gates: [B, S, H].

    Returns (h [B, S, H, D], state (C, n, m)).
    """
    B, S, H, D = q.shape
    k = k / math.sqrt(D)
    C, n, m = initial if initial is not None else _initial_mlstm(B, H, D, q.device)
    logf = F.logsigmoid(f_raw.float())
    hs = []
    for t in range(S):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        it, ft = i_raw[:, t].float(), logf[:, t]
        m_new = torch.maximum(ft + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(ft + m - m_new)
        C = f_s[..., None, None] * C + i_s[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])
        n = f_s[..., None] * n + i_s[..., None] * kt
        num = torch.einsum("bhde,bhe->bhd", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, qt)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    h = torch.stack(hs, dim=1) if hs else q.new_zeros((B, 0, H, D), dtype=torch.float32)
    return h.to(q.dtype), (C, n, m)


def _mlstm_chunk(carry, qc, kc, vc, ic, fc):
    """One chunk of the chunkwise form: inputs [B, L, H, ...] in f32."""
    C, n, m = carry  # [B,H,D,D], [B,H,D], [B,H]
    L = qc.shape[1]
    b = torch.cumsum(fc, dim=1)  # [B, L, H] cumulative log-forget
    # g_i = cummax_{j<=i} (itilde_j - b_j); local max for stabilisation.
    g = torch.cummax(ic - b, dim=1).values
    m_loc = b + torch.maximum(m[:, None, :], g)  # m_i, [B, L, H]
    # Intra-chunk decay matrix: D_ij = exp(b_i - b_j + i_j - m_i), j<=i.
    logD = (b[:, :, None, :] - b[:, None, :, :] + ic[:, None, :, :]
            - m_loc[:, :, None, :])  # [B, i, j, H]
    tri = torch.ones((L, L), dtype=torch.bool, device=qc.device).tril()
    Dm = torch.exp(torch.where(tri[None, :, :, None], logD, -math.inf))
    scores = torch.einsum("bihd,bjhd->bijh", qc, kc) * Dm
    num_intra = torch.einsum("bijh,bjhd->bihd", scores, vc)
    # n contribution: sum_{j<=i} D_ij k_j
    n_intra = torch.einsum("bijh,bjhd->bihd", Dm, kc)
    # Inter-chunk: decay from the carried state.
    inter_scale = torch.exp(b + m[:, None, :] - m_loc)  # [B, L, H]
    num_inter = torch.einsum("bihe,bhde->bihd", qc, C) * inter_scale[..., None]
    n_eff = n_intra + n[:, None, :, :] * inter_scale[..., None]
    num = num_intra + num_inter
    den = torch.maximum(torch.abs(torch.einsum("bihd,bihd->bih", n_eff, qc)),
                        torch.exp(-m_loc))
    h = num / den[..., None]

    # -- state update to the end of the chunk --------------------------------
    m_new = m_loc[:, -1, :]  # [B, H]
    b_last = b[:, -1:, :]  # [B, 1, H]
    w = torch.exp(b_last - b + ic - m_new[:, None, :])  # [B, L, H]
    decay = torch.exp(b_last[:, 0] + m - m_new)
    C_new = C * decay[..., None, None] + torch.einsum("bjh,bjhd,bjhe->bhde", w, vc, kc)
    n_new = n * decay[..., None] + torch.einsum("bjh,bjhd->bhd", w, kc)
    return (C_new, n_new, m_new), h


def mlstm_chunkwise(q, k, v, i_raw, f_raw, *, chunk: int = 64, initial=None):
    """Chunkwise-parallel mLSTM. Same signature/semantics as the oracle.

    Chunks of ``chunk`` steps in order; where ``chunk`` does not divide S
    the last chunk is shorter."""
    B, S, H, D = q.shape
    k = k / math.sqrt(D)
    logf = F.logsigmoid(f_raw.float())
    ii = i_raw.float()
    carry = initial if initial is not None else _initial_mlstm(B, H, D, q.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    hs = []
    for s in range(0, S, chunk):
        e = min(s + chunk, S)
        carry, h = _mlstm_chunk(carry, qf[:, s:e], kf[:, s:e], vf[:, s:e],
                                ii[:, s:e], logf[:, s:e])
        hs.append(h)
    h = torch.cat(hs, dim=1) if hs else qf.new_zeros((B, 0, H, D))
    return h.to(q.dtype), carry


def mlstm_step(q1, k1, v1, i1, f1, state):
    """Single decode step: q1/k1/v1 [B, H, D]; gates [B, H]."""
    h, new_state = mlstm_sequential(
        q1[:, None], k1[:, None], v1[:, None], i1[:, None], f1[:, None],
        initial=state)
    return h[:, 0], new_state


# ---------------------------------------------------------------------------
# sLSTM core (sequential; scalar memory with per-head memory mixing)
# ---------------------------------------------------------------------------

SLSTM_GATES = ("z", "f", "i", "o")


def slstm_scan(x_gates, r_weights, initial=None):
    """x_gates: dict of [B, S, H, D] pre-activations (i, f, z, o from the
    input projections); r_weights: dict of [H, D, D] recurrent (per-head
    block-diagonal) matrices.  Returns (h [B, S, H, D], state (c, n, m, h)).

    The state is kept as [H, B, D] inside the loop, so that a step's four
    recurrent products are one batched product of h against the four
    matrices side by side, [H, D, 4D].
    """
    zi = x_gates["z"]
    B, S, H, D = zi.shape
    dev = zi.device
    if initial is None:
        c = torch.zeros((B, H, D), dtype=torch.float32, device=dev)
        initial = (c, torch.ones_like(c), torch.zeros_like(c), torch.zeros_like(c))
    c, n, m, h = (t.float().transpose(0, 1) for t in initial)  # [H, B, D]
    R = torch.cat([r_weights[g].float() for g in SLSTM_GATES], dim=-1)  # [H, D, 4D]
    # Pre-activations as [S, H, B, 4D], the gates side by side as in R.
    pre = torch.cat([x_gates[g].float() for g in SLSTM_GATES], dim=-1)
    pre = pre.permute(1, 2, 0, 3).contiguous()
    hs = []
    for t in range(S):
        gates = pre[t] + torch.bmm(h, R)
        z_raw, f_raw, i_raw, o_raw = gates.split(D, dim=-1)
        z = torch.tanh(z_raw)
        o = torch.sigmoid(o_raw)
        logf = F.logsigmoid(f_raw)
        m_new = torch.maximum(logf + m, i_raw)
        i_s = torch.exp(i_raw - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * z
        n = f_s * n + i_s
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    out = (torch.stack(hs, dim=2) if hs else pre.new_zeros((H, B, 0, D)))
    state = tuple(t.transpose(0, 1) for t in (c, n, m, h))
    return out.permute(1, 2, 0, 3).to(zi.dtype), state


# ---------------------------------------------------------------------------
# Blocks (projection structure around the cores)
# ---------------------------------------------------------------------------


def mlstm_block_specs(layers: int, d: int, heads: int, head_dim: int) -> dict:
    width = heads * head_dim
    return {
        "w_up": ParamSpec((layers, d, 2 * width), ("layers", "d_model_fsdp", "d_attn"),
                          stddev=fan_in_normal((d, width))),
        "conv1d": ParamSpec((layers, 4, width), ("layers", None, "d_attn"),
                            stddev=0.02),
        "w_q": ParamSpec((layers, width, width), ("layers", None, "d_attn"),
                         stddev=fan_in_normal((width, width))),
        "w_k": ParamSpec((layers, width, width), ("layers", None, "d_attn"),
                         stddev=fan_in_normal((width, width))),
        "w_v": ParamSpec((layers, width, width), ("layers", None, "d_attn"),
                         stddev=fan_in_normal((width, width))),
        "w_gates": ParamSpec((layers, width, 2 * heads), ("layers", "d_attn", None),
                             stddev=fan_in_normal((width, heads))),
        "norm": ParamSpec((layers, width), ("layers", "d_attn"), init="zeros"),
        "w_down": ParamSpec((layers, width, d), ("layers", "d_attn", "d_model_fsdp"),
                            stddev=fan_in_normal((width, d))),
    }


def slstm_block_specs(layers: int, d: int, heads: int, head_dim: int) -> dict:
    width = heads * head_dim
    return {
        "w_in": ParamSpec((layers, d, 4 * width), ("layers", "d_model_fsdp", "d_attn"),
                          stddev=fan_in_normal((d, width))),
        "r": {
            g: ParamSpec((layers, heads, head_dim, head_dim),
                         ("layers", "heads", None, None),
                         stddev=fan_in_normal((head_dim, head_dim)))
            for g in SLSTM_GATES
        },
        "norm": ParamSpec((layers, width), ("layers", "d_attn"), init="zeros"),
        "w_down": ParamSpec((layers, width, d), ("layers", "d_attn", "d_model_fsdp"),
                            stddev=fan_in_normal((width, d))),
    }


def _group_rms(x, scale, heads, eps=1e-6):
    """Per-head RMS norm over head_dim (GroupNorm analogue). x: [B,S,W]."""
    B, S, W = x.shape
    xh = x.reshape(B, S, heads, W // heads).float()
    var = torch.mean(xh * xh, dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + eps)
    return (xh.reshape(B, S, W) * (1.0 + scale.float())).to(x.dtype)


def mlstm_block(params, x, *, heads: int, chunk: int = 64,
                compute_dtype=torch.bfloat16, state=None):
    """x: [B, S, D] -> (out, new_state).  state: (conv, (C, n, m))."""
    B, S, D = x.shape
    xc = x.to(compute_dtype)
    up = xc @ params["w_up"].to(compute_dtype)
    width = up.shape[-1] // 2
    u, gate = up[..., :width], up[..., width:]
    conv_state = state[0] if state is not None else None
    uc, new_conv = causal_conv1d(params["conv1d"], u, conv_state)
    uc = F.silu(uc)
    hd = width // heads

    def heads_of(w):
        return (uc @ w.to(compute_dtype)).reshape(B, S, heads, hd)

    q, k = heads_of(params["w_q"]), heads_of(params["w_k"])
    v = (u @ params["w_v"].to(compute_dtype)).reshape(B, S, heads, hd)
    gates = uc @ params["w_gates"].to(compute_dtype)
    i_raw, f_raw = gates[..., :heads], gates[..., heads:]
    if state is not None:
        h, new_core = mlstm_step(q[:, 0], k[:, 0], v[:, 0],
                                 i_raw[:, 0], f_raw[:, 0], state[1])
        h = h[:, None]
    else:
        h, new_core = mlstm_chunkwise(q, k, v, i_raw, f_raw, chunk=min(chunk, S))
    h = h.reshape(B, S, width)
    h = _group_rms(h, params["norm"], heads)
    h = h * F.silu(gate)
    out = h.to(compute_dtype) @ params["w_down"].to(compute_dtype)
    return out.to(x.dtype), (new_conv, new_core)


def slstm_block(params, x, *, heads: int, compute_dtype=torch.bfloat16, state=None):
    """x: [B, S, D] -> (out, new_state).  state: (c, n, m, h)."""
    B, S, D = x.shape
    pre = x.to(compute_dtype) @ params["w_in"].to(compute_dtype)
    width = pre.shape[-1] // 4
    hd = width // heads
    gates = {g: pre[..., j * width:(j + 1) * width].reshape(B, S, heads, hd)
             for j, g in enumerate(SLSTM_GATES)}
    h, new_state_core = slstm_scan(gates, params["r"], initial=state)
    h = h.reshape(B, S, width)
    h = _group_rms(h, params["norm"], heads)
    out = h.to(compute_dtype) @ params["w_down"].to(compute_dtype)
    return out.to(x.dtype), new_state_core
