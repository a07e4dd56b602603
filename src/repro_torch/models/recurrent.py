"""Griffin / RecurrentGemma RG-LRU recurrent block (arXiv:2402.19427), the
JAX package's ``models/recurrent.py``.

The recurrence (per channel) is

    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t + b_a))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

with an input gate ``i_t = sigmoid(W_x x_t + b_x)``.  The gates are plain
PyTorch in f32; the recurrence itself goes through the RG-LRU scan's entry
point, which runs the CUDA kernel on CUDA tensors and the plain version on
CPU tensors, for a whole prompt and for one decode step alike.

Block structure (Griffin "recurrent block"): two branches from the residual
stream — (linear -> GeLU) gate branch and (linear -> temporal conv1d ->
RG-LRU) recurrent branch — merged by elementwise product and projected back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.common import ParamSpec, fan_in_normal

_C = 8.0  # Griffin's fixed constant c


def rglru_param_specs(layers: int, width: int) -> dict:
    return {
        "lambda": ParamSpec((layers, width), ("layers", "rnn_state"),
                            init="rglru_lambda"),
        "w_a": ParamSpec((layers, width), ("layers", "rnn_state"),
                         init="normal", stddev=fan_in_normal((width, width))),
        "b_a": ParamSpec((layers, width), ("layers", "rnn_state"), init="zeros"),
        "w_x": ParamSpec((layers, width), ("layers", "rnn_state"),
                         init="normal", stddev=fan_in_normal((width, width))),
        "b_x": ParamSpec((layers, width), ("layers", "rnn_state"), init="zeros"),
    }


def recurrent_block_specs(layers: int, d: int, width: int, conv_w: int) -> dict:
    return {
        "w_branch_x": ParamSpec((layers, d, width),
                                ("layers", "d_model_fsdp", "rnn_state"),
                                stddev=fan_in_normal((d, width))),
        "w_branch_gate": ParamSpec((layers, d, width),
                                   ("layers", "d_model_fsdp", "rnn_state"),
                                   stddev=fan_in_normal((d, width))),
        "conv1d": ParamSpec((layers, conv_w, width),
                            ("layers", None, "rnn_state"), stddev=0.02),
        "w_out": ParamSpec((layers, width, d),
                           ("layers", "rnn_state", "d_model_fsdp"),
                           stddev=fan_in_normal((width, d))),
        "rglru": rglru_param_specs(layers, width),
    }


def _gates(params: dict, x: torch.Tensor):
    """Per-timestep gate values. x: [B, S, W] (bf16 ok, gates in f32)."""
    xf = x.float()
    # jax.nn.softplus is logaddexp(x, 0); F.softplus is log1p(exp(x)) up to
    # its threshold of 20 and x above it.  Lambda lies in about (-4.4, 1.0)
    # (the "rglru_lambda" init), where the two agree to rounding.
    log_a_scale = -_C * F.softplus(params["lambda"].float())
    r = torch.sigmoid(xf * params["w_a"].float() + params["b_a"].float())
    log_a = log_a_scale * r  # [B, S, W], <= 0
    a = torch.exp(log_a)
    gated_x = xf * torch.sigmoid(xf * params["w_x"].float() + params["b_x"].float())
    # sqrt(1 - a^2) computed stably via expm1: 1 - exp(2 log a).
    beta = torch.sqrt(-torch.expm1(2.0 * log_a) + 1e-12)
    return a, beta * gated_x


def rglru_scan(params: dict, x: torch.Tensor, h0: torch.Tensor | None = None):
    """RG-LRU over a sequence. x: [B, S, W] -> (y [B, S, W], h_last f32).

    The JAX model folds ``h0`` into the first step and runs an associative
    scan; the kernel carries ``h0`` and walks t in order.  The two differ by
    rounding only.
    """
    a, bx = _gates(params, x)
    h, h_last = rglru_ops.rglru_scan(a, bx, h0)
    return h.to(x.dtype), h_last


def rglru_step(params: dict, x_t: torch.Tensor, h: torch.Tensor):
    """Single decode step. x_t: [B, W]; h: [B, W] -> (y_t, h').

    The scan at S = 1 from ``h`` computes exactly the JAX package's step:
    ``h' = a * h + bx`` in f32, and ``y_t = h'`` in ``x_t.dtype``.
    """
    y, h_new = rglru_scan(params, x_t[:, None], h)
    return y[:, 0], h_new


def causal_conv1d(w: torch.Tensor, x: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv. w: [K, W]; x: [B, S, W]; state: [B, K-1, W].

    The taps are summed in f32 in order k = 0..K-1, as in the JAX package;
    ``F.conv1d`` would sum in another order, and on the card a float32
    convolution goes through cuDNN in TF32 by default.  The new state is the
    last K-1 rows of ``[state; x]``: for S < K-1 it keeps rows of the old
    state (zeros in a prefill).
    """
    K = w.shape[0]
    B, S, W = x.shape
    if state is None:
        pad = torch.zeros((B, K - 1, W), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, W]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + xp[:, k:k + S].float() * w[k].float()
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out.to(x.dtype), new_state


def recurrent_block(params: dict, x: torch.Tensor, *,
                    compute_dtype=torch.bfloat16, state: dict | None = None):
    """Griffin recurrent block.  x: [B, S, D].

    ``state`` (decode): {"h": [B, W], "conv": [B, K-1, W]}.  Returns
    (out [B, S, D], new_state {"h", "conv"}); the caller stores the state.
    """
    xc = x.to(compute_dtype)
    # jax.nn.gelu defaults to the tanh approximation, F.gelu to the exact erf
    # form, which is about 1e-3 away: beyond the 2e-4 logit tolerance.
    gate = F.gelu(xc @ params["w_branch_gate"].to(compute_dtype),
                  approximate="tanh")
    u = xc @ params["w_branch_x"].to(compute_dtype)
    conv_state = state["conv"] if state is not None else None
    u, new_conv = causal_conv1d(params["conv1d"], u, conv_state)
    if state is not None:
        y, h_new = rglru_step(params["rglru"], u[:, 0], state["h"])
        y = y[:, None]
    else:
        y, h_new = rglru_scan(params["rglru"], u)
    merged = y * gate
    out = merged.to(compute_dtype) @ params["w_out"].to(compute_dtype)
    return out.to(x.dtype), {"h": h_new, "conv": new_conv}
