"""Parameter plumbing: the JAX package's :class:`ParamSpec` trees.

Models declare their parameters as trees of :class:`ParamSpec` (shape,
logical axes, initializer), and ``init_params`` materialises one; with
sharding rules each leaf becomes a DTensor placed by its logical axes.
``param_structs`` gives the same tree as fake DTensors (the dry-run's
inputs) and ``param_shardings`` the ``(mesh, placements)`` of each leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | rglru_lambda
    stddev: float = 0.02

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(
                f"ParamSpec rank mismatch: {self.shape} vs {self.logical_axes}"
            )


def fan_in_normal(shape: tuple[int, ...], fan_axis: int = -2) -> float:
    """1/sqrt(fan_in) stddev for weight matrices."""
    if len(shape) < 2:
        return 0.02
    return 1.0 / math.sqrt(shape[fan_axis])


def _iter_leaves(tree: Any, prefix: str = ""):
    if isinstance(tree, ParamSpec):
        yield prefix, tree
        return
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k], f"{prefix}/{k}")
        return
    raise TypeError(f"unexpected node in param spec tree at {prefix}: {type(tree)}")


def count_params(spec_tree: Any) -> int:
    return sum(math.prod(s.shape) for _p, s in _iter_leaves(spec_tree))


def _path_hash(path: str) -> int:
    h = 2166136261
    for ch in path.encode():
        h = ((h ^ ch) * 16777619) & 0x7FFFFFFF
    return h


def rglru_lambda_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Griffin's Lambda from forget rates ``u`` in (0.9, 0.999): the value
    with ``softplus(Lambda) = -log(u) / c * 100`` (c = 8), in float32."""
    return torch.log(torch.expm1(-torch.log(u) * (1.0 / 8.0) * 100.0) + 1e-8)


def _init_leaf(spec: ParamSpec, seed: int, path: str, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init not in ("normal", "rglru_lambda"):
        raise ValueError(f"unknown init {spec.init!r}")
    gen = torch.Generator(device)
    gen.manual_seed(seed * 2**31 + _path_hash(path))
    if spec.init == "rglru_lambda":
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                       device=device) * (0.999 - 0.9) + 0.9
        return rglru_lambda_from_uniform(u).to(dtype)
    out = torch.randn(spec.shape, generator=gen, dtype=dtype, device=device)
    return out.mul_(spec.stddev)


def init_params(spec_tree: Any, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, rules=None) -> Any:
    """Materialise a parameter tree on ``device`` (default: the card).

    Each leaf is drawn in ``dtype`` from its own generator, seeded from
    ``seed`` and its path, so a full-width model is made leaf by leaf on the
    card and never as a whole float32 copy.  The numbers are not
    ``jax.random``'s: to compute what the JAX package computes, carry its
    parameters across with ``models.convert.params_from_numpy``.  With
    ``rules`` (``core.channels.ShardingRules``) each leaf is a DTensor
    placed by its logical axes; every rank draws the same leaf and keeps
    its shard.
    """
    dev = resolve_device(device)

    def build(tree: Any, prefix: str = "") -> Any:
        if isinstance(tree, ParamSpec):
            leaf = _init_leaf(tree, seed, prefix, dev, dtype)
            return leaf if rules is None else rules.distribute(
                leaf, tree.logical_axes)
        return {k: build(v, f"{prefix}/{k}") for k, v in tree.items()}

    return build(spec_tree)


def param_structs(spec_tree: Any, rules, dtype: torch.dtype = torch.float32,
                  mode=None) -> Any:
    """The parameter tree as fake DTensors placed by ``rules``: the
    dry-run's inputs (no allocation)."""
    from repro_torch.core.channels import fake_struct

    def build(tree: Any) -> Any:
        if isinstance(tree, ParamSpec):
            return fake_struct(rules, tree.shape, dtype, tree.logical_axes,
                               mode=mode)
        return {k: build(v) for k, v in tree.items()}

    return build(spec_tree)


def param_shardings(spec_tree: Any, rules) -> Any:
    """``(mesh, placements)`` per leaf."""
    def build(tree: Any) -> Any:
        if isinstance(tree, ParamSpec):
            return rules.sharding(tree.shape, tree.logical_axes)
        return {k: build(v) for k, v in tree.items()}

    return build(spec_tree)
