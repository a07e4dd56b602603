"""Deterministic synthetic data pipeline (the Emit substrate).

The stream is the JAX package's, bit for bit:
``tokens[step] = Philox(key=seed + (step << 20))`` drawn by numpy, so every
restart or resume reproduces it exactly (a checkpoint records only the
step).  Batches are numpy on the host and tensors on the trainer's device;
``DataPipeline`` builds the next one ahead of need (one-batch prefetch).  With sharding rules a batch is a set of DTensors
(``shard_batch``): each rank keeps its own rows of the global numpy batch.

A real corpus plugs in by implementing :class:`BatchSource`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Protocol

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.processes import EmitDetails
from repro_torch.device import resolve_device
from repro_torch.kernels._shard import contiguous_stride


class BatchSource(Protocol):
    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Return the global numpy batch for ``step``."""


@dataclass
class SyntheticLM(BatchSource):
    """Philox-counter LM stream: reproducible, seekable, infinite."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_len: int = 0
    d_model: int = 0  # for frontend stub embeddings
    encdec: bool = False

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.Philox(key=self.seed + (step << 20))
        gen = np.random.Generator(rng)
        B, S = self.global_batch, self.seq_len
        tokens = gen.integers(0, self.vocab_size, size=(B, S + 1), dtype=np.int32)
        out = {"tokens": tokens[:, :S], "targets": tokens[:, 1:]}
        if self.encdec:
            out["frames"] = gen.standard_normal((B, S, self.d_model)).astype(
                np.float32
            )
        elif self.frontend_len:
            out["extra_embeds"] = gen.standard_normal(
                (B, self.frontend_len, self.d_model)
            ).astype(np.float32)
        return out


BATCH_AXES: dict[str, tuple] = {
    "tokens": ("batch", "seq"),
    "targets": ("batch", "seq"),
    "extra_embeds": ("batch", "seq", "d_model"),
    "frames": ("batch", "seq", "d_model"),
}


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    """Token ids as int64 (PyTorch's index type), the rest as they are."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return (t.long() if t.dtype == torch.int32 else t).to(device)


def shard_batch(batch: dict[str, np.ndarray], rules, device=None) -> dict:
    """Global DTensors from the (host-local) numpy batch: each rank copies
    only its own shard of each array to ``device`` (default: the rules'
    mesh's device type)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    dev = device if device is not None else rules.mesh.device_type
    out = {}
    for name, arr in batch.items():
        mesh, placements = rules.sharding(arr.shape, BATCH_AXES[name])
        local_shape, offset = compute_local_shape_and_global_offset(
            arr.shape, mesh, placements)
        index = tuple(slice(o, o + n) for o, n in zip(offset, local_shape))
        local = _tensor(arr[index], dev)
        out[name] = DTensor.from_local(local, mesh, placements, run_check=False,
                                       shape=torch.Size(arr.shape),
                                       stride=contiguous_stride(arr.shape))
    return out


def source_for(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0) -> SyntheticLM:
    return SyntheticLM(
        vocab_size=cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        frontend_len=cfg.frontend_len if cfg.frontend == "vit" else 0,
        d_model=cfg.d_model,
        encdec=bool(cfg.encoder_layers),
    )


class DataPipeline:
    """step -> batch of tensors on ``device`` (default: the card), with
    one-batch prefetch; with ``rules``, a batch of DTensors
    (``shard_batch``)."""

    def __init__(self, source: BatchSource, device=None, rules=None):
        self.source = source
        self.device = resolve_device(device)
        self.rules = rules
        self._prefetched: tuple[int, Any] | None = None

    def get(self, step: int) -> dict:
        if self._prefetched is not None and self._prefetched[0] == step:
            batch = self._prefetched[1]
            self._prefetched = None
            return batch
        return self._materialise(step)

    def prefetch(self, step: int) -> None:
        if self._prefetched is None or self._prefetched[0] != step:
            self._prefetched = (step, self._materialise(step))

    def _materialise(self, step: int) -> dict:
        batch = self.source.batch(step)
        if self.rules is not None:
            return shard_batch(batch, self.rules, self.device)
        return {name: _tensor(arr, self.device) for name, arr in batch.items()}


def emit_details_for(source: BatchSource, num_steps: int) -> EmitDetails:
    """Adapter: the data pipeline as the DSL's Emit stage (``Mdata`` role)."""

    def create(state):
        step = state
        if step >= num_steps:
            return None, state
        return (step, source.batch(step)), step + 1

    return EmitDetails(name=type(source).__name__, create=create,
                       init=lambda: 0, init_data=())
