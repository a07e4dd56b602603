"""Shared layers: RMS norm, the SwiGLU MLP, embeddings and the LM head.

The products are plain ``torch.matmul`` (the JAX package leaves them to
XLA); the RMS norm goes through the fused kernel's entry point, which runs
the CUDA kernel on CUDA tensors and the plain version on CPU tensors.
Weights are cast to the compute dtype where they are used, as in the JAX
package; a cast to the dtype a weight already has is free, so a caller may
store the weights once in the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rms_norm  # noqa: F401 (the models' norm)
from repro_torch.models.common import ParamSpec, fan_in_normal


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, compute_dtype=torch.bfloat16):
    """x: [..., D]; w_gate/w_up: [D, F]; w_down: [F, D]."""
    xc = x.to(compute_dtype)
    g = xc @ w_gate.to(compute_dtype)
    u = xc @ w_up.to(compute_dtype)
    return (F.silu(g) * u) @ w_down.to(compute_dtype)


def mlp_specs(d: int, f: int, layers: int) -> dict:
    return {
        "w_gate": ParamSpec(
            (layers, d, f), ("layers", "d_model_fsdp", "d_ff"),
            stddev=fan_in_normal((d, f)),
        ),
        "w_up": ParamSpec(
            (layers, d, f), ("layers", "d_model_fsdp", "d_ff"),
            stddev=fan_in_normal((d, f)),
        ),
        "w_down": ParamSpec(
            (layers, f, d), ("layers", "d_ff", "d_model_fsdp"),
            stddev=fan_in_normal((f, d)),
        ),
    }


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor, compute_dtype):
    return embedding[tokens].to(compute_dtype)


def lm_logits(x: torch.Tensor, head: torch.Tensor, compute_dtype,
              softcap: float = 0.0) -> torch.Tensor:
    logits = x.to(compute_dtype) @ head.to(compute_dtype)
    if softcap > 0:  # in f32, as the JAX package's layers.lm_logits
        logits = softcap * torch.tanh(logits.float() / softcap)
    return logits
