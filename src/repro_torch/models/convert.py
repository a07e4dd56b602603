"""Carry the JAX package's parameters into the port.

The JAX package's parameter trees are nested dicts of arrays (``embed``,
``final_norm``, ``lm_head``, ``blocks/<kind>/{ln1, wq, wk, wv, wo, ln2,
mlp/{w_gate, w_up, w_down}}`` for the attention kinds, ``moe/{router,
w_gate, w_up, w_down, shared_w_*}`` in place of ``mlp`` for ``moe``,
``rec/{..., rglru/{...}}`` for the recurrent kind, ``core/{..., r/{z, f,
i, o}}`` for the xLSTM kinds, and ``encoder``/``decoder`` stacks with
``self``/``cross`` projections for the encoder-decoder); handed over as
numpy arrays with the same keys, at any depth of nesting, they become the
port's tree of tensors, key for key.  ``jax.random`` and
``torch.Generator`` give different numbers from one seed, so this is how
the two packages are made to compute the same thing.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree: Any, device=None,
                      dtype: torch.dtype = torch.float32) -> Any:
    """numpy leaves -> tensors of ``dtype`` on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def build(node: Any) -> Any:
        if isinstance(node, Mapping):
            return {k: build(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(dev, dtype)

    return build(tree)
