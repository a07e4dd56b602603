"""AdamW with global-norm clipping over a tree (nested dicts) of tensors.

The state is the JAX package's: ``{"m": tree, "v": tree, "count": int32}``,
the moments in ``AdamWConfig.state_dtype`` (float32 by default).  Unlike
the reference, which returns new arrays, ``apply_updates`` writes the new
parameters and moments into the tensors it is given (PyTorch's idiom: a
3.3 B-parameter model's state would not fit twice on one card) and returns
the same trees.  A caller that needs the old values copies them first; the
checkpoint manager's ``save_async`` copies to the host before it returns.
Each leaf's update is ``kernels.adamw.ops.adamw_update``: one kernel
launch on the card, bit for bit the plain loop the CPU runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.kernels.adamw.ops import adamw_update


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # Optimizer-state dtype: float32 (default) or bfloat16 (memory-lean mode).
    state_dtype: str = "float32"


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict, in sorted key order (the JAX package's
    flattening order for dict trees)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` on every leaf, visited in ``tree_leaves``'s order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def init_state(params: Any, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    # zeros_like: a DTensor parameter's moments take its placements
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply_updates(
    params: Any,
    grads: Any,
    state: dict,
    cfg: AdamWConfig,
    lr: torch.Tensor,
) -> tuple[Any, dict, dict]:
    """One AdamW step, in place.  Returns (params, state, metrics)."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    countf = count.float()
    b1c = 1.0 - torch.pow(cfg.b1, countf)
    b2c = 1.0 - torch.pow(cfg.b2, countf)
    lr = lr.to(gnorm.device)

    # One launch a leaf on the card (``kernels/adamw``), the plain loop on
    # the CPU; a DTensor leaf is updated on its local shards.
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        adamw_update(p, g, m, v, scale, b1c, b2c, lr, cfg.b1, cfg.b2, cfg.eps,
                     cfg.weight_decay)
    state["count"] = count
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state, metrics
