"""Step-function factories (the JAX package's ``runtime/steps.py`` at one
device), for decoder-only and encoder-decoder models alike:

* ``make_train_step``   — forward, backward and AdamW under warmup-cosine;
* ``make_prefill_step`` — full-sequence forward to last-token logits;
* ``make_decode_step``  — one token against the KV cache.

PyTorch runs eagerly, so a factory returns a plain closure; there is no
``jit`` and no sharding.  ``tp > 1`` and the dry-run structs wait for the
port's sharding work (ROADMAP item 9).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import lm_logits
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine


def model_param_specs(cfg: ModelConfig):
    if cfg.encoder_layers:
        return encdec_mod.encdec_param_specs(cfg)
    return lm_mod.lm_param_specs(cfg)


def loss_fn_for(cfg: ModelConfig) -> Callable:
    if cfg.encoder_layers:
        return lambda p, b: encdec_mod.encdec_loss(cfg, p, b)
    return lambda p, b: lm_mod.lm_loss(cfg, p, b)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10000,
) -> Callable:
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``ce_loss``, ``grad_norm`` and ``lr``
    (0-d tensors), and a MoE model's three aux values.  The parameters and moments are updated in place
    (``adamw.apply_updates``); the gradients live only inside the call."""
    loss_fn = loss_fn_for(cfg)

    def train_step(params, opt_state, batch, step):
        leaves = adamw.tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        flat = iter(torch.zeros_like(p) if g is None else g
                    for p, g in zip(leaves, grads))
        grads = adamw.tree_map(lambda _p: next(flat), params)
        lr = warmup_cosine(step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                           total_steps=total_steps)
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg, lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, batch) -> [B, Vp]`` last-token logits.  An
    encoder-decoder model encodes ``batch["frames"]`` first; a decoder-only
    model takes ``batch["extra_embeds"]`` as its prefix where present."""
    if cfg.encoder_layers:
        def prefill_step(params, batch):
            enc_out = encdec_mod.encode(cfg, params, batch["frames"])
            x = encdec_mod.decode_train(cfg, params, batch["tokens"], enc_out)
            return lm_logits(x[:, -1:], params["lm_head"],
                             lm_mod._dtype(cfg.compute_dtype))[:, 0]
    else:
        def prefill_step(params, batch):
            x, _aux = lm_mod.forward_hidden(
                cfg, params, batch["tokens"],
                extra_embeds=batch.get("extra_embeds"))
            return lm_mod.logits_from_hidden(cfg, params, x[:, -1:])[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    if cfg.encoder_layers:
        def decode_step(params, cache, tokens, cache_len):
            return encdec_mod.encdec_decode_step(cfg, params, cache, tokens,
                                                 cache_len)
    else:
        def decode_step(params, cache, tokens, cache_len):
            return lm_mod.decode_step(cfg, params, cache, tokens, cache_len)

    return decode_step
