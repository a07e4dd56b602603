"""Shared layers: RMS norm, the SwiGLU MLP, embeddings, the LM head and the
chunked cross-entropy.

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
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import _shard
from repro_torch.kernels._shard import is_dtensor
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
    if is_dtensor(embedding, tokens):
        if torch.is_grad_enabled() and embedding.requires_grad:
            return _embed_local(embedding, tokens, compute_dtype)
        # without a gradient: DTensor's vocab-parallel lookup (each shard
        # reads its rows of the table; the rows are summed), no gather of
        # the vocab.  The table's d_model shards are gathered first: with
        # them, the mask of a token shard met the gathered output's rows.
        table = embedding.redistribute(embedding.device_mesh,
                                       _shard.keep_shards(embedding, (0,)))
        return F.embedding(tokens, table).to(compute_dtype)
    # index_select, whose gradient on the card is deterministic under
    # torch.use_deterministic_algorithms (a replayed step gives the same bits)
    rows = torch.index_select(embedding, 0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, embedding.shape[1]).to(compute_dtype)


def _embed_local(embedding, tokens, compute_dtype):
    """The lookup on each shard's token rows against the table gathered
    whole (its gradient partial over the token shards): DTensor's own
    lookup strategies, sound forward, fail in the backward for a table
    sharded over vocab and d_model (a mask of the token shard's shape
    against the gradient's)."""
    from torch.distributed.tensor import Replicate

    if is_dtensor(tokens):
        rows = _shard.row_placements(tokens)
        local_tokens = _shard.local(tokens, rows)
    else:
        rows = (Replicate(),) * embedding.device_mesh.ndim
        local_tokens = tokens
    out = embed_tokens(_shard.replicated(embedding, rows), local_tokens,
                       compute_dtype)
    like = tokens if is_dtensor(tokens) else embedding
    return _shard.wrap(out, like, rows, (*tokens.shape, embedding.shape[1]))


def lm_logits(x: torch.Tensor, head: torch.Tensor, compute_dtype,
              softcap: float = 0.0) -> torch.Tensor:
    logits = x.to(compute_dtype) @ head.to(compute_dtype)
    if softcap > 0:  # in f32, as the JAX package's layers.lm_logits
        logits = softcap * torch.tanh(logits.float() / softcap)
    return logits


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------

NEG_INF_F32 = -1e30


def _chunk_ce_sum(xc, head, tc, vocab_size: int, softcap: float,
                  compute_dtype) -> torch.Tensor:
    """sum(logsumexp - target logit) over one chunk, in f32."""
    logits = lm_logits(xc, head, compute_dtype, softcap).float()
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    logits = torch.where(pad, NEG_INF_F32, logits)
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # vocab may be sharded: pick the target's logit by a masked sum
        # (one nonzero term), which DTensor reduces like any sum
        ids = torch.arange(logits.shape[-1], device=logits.device)
        hit = ids == tc.unsqueeze(-1)
        tgt = torch.where(hit, logits, 0.0).sum(-1)
    else:
        tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
    return torch.sum(lse - tgt)


def chunked_cross_entropy(
    x: torch.Tensor,
    head: torch.Tensor,
    targets: torch.Tensor,
    *,
    vocab_size: int,
    seq_chunk: int = 512,
    softcap: float = 0.0,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Mean next-token CE without materialising [B, S, V] f32 logits.

    ``x``: [B, S, D] final hidden states; ``head``: [D, V_padded];
    ``targets``: [B, S] integer ids.  Walks the sequence in chunks: each
    materialises only [B, chunk, V_padded] logits, and under autograd
    recomputes them in the backward (``torch.utils.checkpoint``), so one
    chunk's logits are live at a time.  Padded vocab entries are masked with
    -1e30; the sum over chunks is f32, divided by B * S.
    """
    B, S, _D = x.shape
    seq_chunk = min(seq_chunk, S)
    if S % seq_chunk != 0:
        raise ValueError(f"S={S} not divisible by seq_chunk={seq_chunk}")
    targets = targets.long()
    remat = torch.is_grad_enabled() and (x.requires_grad or head.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, seq_chunk):
        args = (x[:, i:i + seq_chunk], head, targets[:, i:i + seq_chunk],
                vocab_size, softcap, compute_dtype)
        part = checkpoint(_chunk_ce_sum, *args, use_reentrant=False) if remat \
            else _chunk_ce_sum(*args)
        total = total + part
    return total / (B * S)
