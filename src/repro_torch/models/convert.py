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
the two packages are made to compute the same thing.  A JAX tree made at
``tp > 1`` (padded q heads, KV heads and vocab) carries across the same
way, padded leaves included.

``pad_for_tp`` is the carrying function between degrees: a tp = 1 tree
zero-padded at the end of every dim to the shapes ``lm_param_specs(cfg,
tp)`` (or the encoder-decoder's) gives.  Padded q heads read zero
projections and feed zero ``wo`` rows, padded KV heads serve only padded
q heads, and padded vocab rows and columns are masked at the loss and cut
from the logits, so the model computes what it did at tp = 1.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ParamSpec


def params_from_numpy(tree: Any, device=None,
                      dtype: torch.dtype = torch.float32) -> Any:
    """numpy leaves -> tensors of ``dtype`` on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def build(node: Any) -> Any:
        if isinstance(node, Mapping):
            return {k: build(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(dev, dtype)

    return build(tree)


def pad_for_tp(cfg, params: Any, tp: int) -> Any:
    """A tp = 1 parameter tree as the tree of degree ``tp`` (zeros at the
    end of every dim the padded plan widens)."""
    from repro_torch.models.encdec import encdec_param_specs
    from repro_torch.models.lm import lm_param_specs

    specs = (encdec_param_specs(cfg, tp) if cfg.encoder_layers
             else lm_param_specs(cfg, tp))

    def pad(spec: Any, leaf: Any) -> Any:
        if not isinstance(spec, ParamSpec):
            return {k: pad(spec[k], leaf[k]) for k in spec}
        if tuple(leaf.shape) == spec.shape:
            return leaf
        out = leaf.new_zeros(spec.shape)
        out[tuple(slice(0, n) for n in leaf.shape)] = leaf
        return out

    return pad(specs, params)
