"""Deterministic synthetic data pipeline (the Emit substrate).

The stream is the JAX package's, bit for bit:
``tokens[step] = Philox(key=seed + (step << 20))`` drawn by numpy, so every
restart or resume reproduces it exactly (a checkpoint records only the
step).  Batches are numpy on the host and tensors on the trainer's device;
``DataPipeline`` builds the next one ahead of need (one-batch prefetch).
Sharding a batch over a mesh (``shard_batch``) waits for the port's
sharding work (ROADMAP item 9).

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
    one-batch prefetch."""

    def __init__(self, source: BatchSource, device=None):
        self.source = source
        self.device = resolve_device(device)
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
        """Token ids as int64 (PyTorch's index type), the rest as they are."""
        out = {}
        for name, arr in self.source.batch(step).items():
            t = torch.from_numpy(np.ascontiguousarray(arr))
            out[name] = (t.long() if t.dtype == torch.int32 else t).to(self.device)
        return out


def emit_details_for(source: BatchSource, num_steps: int) -> EmitDetails:
    """Adapter: the data pipeline as the DSL's Emit stage (``Mdata`` role)."""

    def create(state):
        step = state
        if step >= num_steps:
            return None, state
        return (step, source.batch(step)), step + 1

    return EmitDetails(name=type(source).__name__, create=create,
                       init=lambda: 0, init_data=())
