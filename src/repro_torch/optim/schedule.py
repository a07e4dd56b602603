"""Learning-rate schedules (warmup + cosine decay, the LM default).

Computed in float32 tensors, step by step as the JAX package computes them,
so that a rate equals the reference's within one ulp.  The cosine is taken
in float64 and rounded once: that gives XLA's float32 cosine on the CPU,
where ``torch.cos`` in float32 can be an ulp away, and ``1 + cos`` near
cos = -1 would turn one ulp into several.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def warmup_cosine(
    step,
    *,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_fraction: float = 0.1,
) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
    )
    pi = torch.tensor(math.pi, dtype=torch.float32)
    cos = final_fraction + (1 - final_fraction) * 0.5 * (
        1 + torch.cos((pi * progress).double()).float()
    )
    return torch.where(step < warmup_steps, warm, peak_lr * cos)


def constant(step, *, peak_lr: float, **_kw) -> torch.Tensor:
    del step
    return torch.tensor(peak_lr, dtype=torch.float32)
