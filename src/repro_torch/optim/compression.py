"""Gradient compression with error feedback (the JAX package's
``optim/compression.py``).

Two compressors, both carrying the residual of the lossy cast into the
next step:

* ``bf16`` — cast float32 grads to bfloat16 on the wire (2x);
* ``int8`` — per-row affine int8 quantisation (4x).

At one device no gradient crosses a wire, so the train step does not call
these; they are the substrate of a data-parallel step (ROADMAP, sharding).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


def init_error_feedback(params: Any) -> Any:
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def _quant_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(x.shape[0] if x.dim() > 1 else 1, -1).float()
    scale = torch.amax(torch.abs(flat), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.float() * scale).reshape(shape)


def _zip_map(fn, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _split(pairs: Any) -> tuple[Any, Any]:
    if isinstance(pairs, dict):
        halves = {k: _split(v) for k, v in pairs.items()}
        return ({k: h[0] for k, h in halves.items()},
                {k: h[1] for k, h in halves.items()})
    return pairs


def compress(grads: Any, errors: Any, mode: str) -> tuple[Any, Any, Any]:
    """Returns (wire_tree, decompress_meta, new_errors).

    ``wire_tree`` is what would travel through the collective; adding the
    carried error before compression and keeping the new residual after
    implements error feedback.
    """
    if mode == "none":
        return grads, None, errors

    if mode == "bf16":
        def leaf(g, e):
            corrected = g.float() + e
            wire = corrected.to(torch.bfloat16)
            return wire, corrected - wire.float()

        wire, new_err = _split(_zip_map(leaf, grads, errors))
        return wire, None, new_err

    if mode == "int8":
        def leaf(g, e):
            corrected = g.float() + e
            q, scale = _quant_int8(corrected)
            deq = _dequant_int8(q, scale, corrected.shape)
            return (q, scale), corrected - deq

        wire, new_err = _split(_zip_map(leaf, grads, errors))
        shapes = tree_map(lambda g: tuple(g.shape), grads)
        return wire, shapes, new_err

    raise ValueError(f"unknown compression mode {mode!r}")


def decompress(wire: Any, meta: Any, mode: str) -> Any:
    if mode == "none":
        return wire
    if mode == "bf16":
        return tree_map(lambda w: w.float(), wire)
    if mode == "int8":
        return _zip_map(lambda pair, shape: _dequant_int8(*pair, shape),
                        wire, meta)
    raise ValueError(f"unknown compression mode {mode!r}")


def wire_bytes(tree: Any, mode: str) -> int:
    """Bytes on the wire for one gradient exchange (reporting helper)."""
    del mode  # an int8 leaf is its (q, scale) pair: both travel
    total = 0
    for leaf in tree_leaves(tree):
        parts = leaf if isinstance(leaf, tuple) else (leaf,)
        total += sum(math.prod(x.shape) * x.element_size() for x in parts)
    return total
