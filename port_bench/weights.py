"""Seeded weights, made on the device by the benchmark and handed alike to
the program and to the plain reference.

The tree is the program's parameter layout (``lm_param_specs``: per block
kind, each leaf stacked over that kind's layers); its values are the
benchmark's own.  Each leaf is one ``randn`` call from a generator on the
device seeded by ``--seed`` and the leaf's path, scaled by the spec's
standard deviation, in the dtype the configuration keeps its weights in;
norm scales start at zero.  So any one leaf can be made again alone, as
the training check does for the parameters' change.
"""

from __future__ import annotations

import hashlib

import torch


def leaf_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{seed}/{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def spec_leaves(specs, prefix: str = "") -> list[tuple[str, object]]:
    """(path, spec) of every leaf of a spec tree, in sorted key order."""
    if isinstance(specs, dict):
        out = []
        for key in sorted(specs):
            out += spec_leaves(specs[key], f"{prefix}/{key}")
        return out
    return [(prefix, specs)]


def make_leaf(spec, seed: int, path: str, dtype: torch.dtype,
              device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init != "normal":
        raise ValueError(f"{path}: no benchmark initialiser for {spec.init!r}")
    gen = torch.Generator(device)
    gen.manual_seed(leaf_seed(seed, path))
    out = torch.randn(spec.shape, generator=gen, dtype=dtype, device=device)
    return out.mul_(spec.stddev)


def make_tree(specs, seed: int, dtype: torch.dtype, device) -> dict:
    """The whole weight tree, nested as ``specs``."""
    tree: dict = {}
    for path, spec in spec_leaves(specs):
        node = tree
        *parents, name = path.strip("/").split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = make_leaf(spec, seed, path, dtype, device)
    return tree


def tree_get(tree: dict, path: str):
    for key in path.strip("/").split("/"):
        tree = tree[key]
    return tree
