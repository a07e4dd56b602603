"""Step-function factories (the JAX package's ``runtime/steps.py``), for
decoder-only and encoder-decoder models alike:

* ``make_train_step``   — forward, backward and AdamW under warmup-cosine;
* ``make_prefill_step`` — full-sequence forward to last-token logits;
* ``make_decode_step``  — one token against the KV cache;
* ``*_structs``         — the matching fake-tensor inputs (DTensors placed
  by the rules, no allocation): the dry-run's inputs.

PyTorch runs eagerly, so a factory returns a plain closure; there is no
``jit``.  With ``rules`` the parameters, batch and cache are DTensors on
the rules' mesh and the step runs under DTensor dispatch (``lm.spmd``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.channels import ShardingRules, fake_struct
from repro_torch.data.pipeline import BATCH_AXES
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.common import param_structs
from repro_torch.models.layers import lm_logits
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine

ENC_LEN_CAP = 4096  # encoder frames for decode shapes (source is bounded)


def model_param_specs(cfg: ModelConfig, tp: int = 1):
    if cfg.encoder_layers:
        return encdec_mod.encdec_param_specs(cfg, tp)
    return lm_mod.lm_param_specs(cfg, tp)


def loss_fn_for(cfg: ModelConfig, tp: int = 1,
                rules: ShardingRules | None = None) -> Callable:
    if cfg.encoder_layers:
        return lambda p, b: encdec_mod.encdec_loss(cfg, p, b, tp=tp, rules=rules)
    return lambda p, b: lm_mod.lm_loss(cfg, p, b, tp=tp, rules=rules)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    tp: int = 1,
    rules: ShardingRules | None = None,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10000,
) -> Callable:
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``ce_loss``, ``grad_norm`` and ``lr``
    (0-d tensors), and a MoE model's three aux values.  The parameters and moments are updated in place
    (``adamw.apply_updates``); the gradients live only inside the call.
    With ``rules``, the forward and the backward run under DTensor dispatch
    and the metrics come back as 0-d DTensors.  The profiler spans
    ``train.forward``, ``train.backward`` (a recompute included) and
    ``train.optimizer`` split the step."""
    loss_fn = loss_fn_for(cfg, tp, rules)

    def train_step(params, opt_state, batch, step):
        leaves = adamw.tree_leaves(params)
        with lm_mod.spmd(rules):
            for leaf in leaves:
                leaf.requires_grad_(True)
            try:
                with record_function("train.forward"):
                    loss, metrics = loss_fn(params, batch)
                with record_function("train.backward"):
                    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            finally:
                for leaf in leaves:
                    leaf.requires_grad_(False)
            flat = iter(torch.zeros_like(p) if g is None else g
                        for p, g in zip(leaves, grads))
            grads = adamw.tree_map(lambda _p: next(flat), params)
            lr = warmup_cosine(step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                               total_steps=total_steps)
            with record_function("train.optimizer"):
                params, opt_state, opt_metrics = adamw.apply_updates(
                    params, grads, opt_state, opt_cfg, lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def train_state_structs(cfg: ModelConfig, rules: ShardingRules, tp: int,
                        opt_cfg: adamw.AdamWConfig, mode=None):
    """(param structs, opt-state structs) for the dry-run: fake DTensors
    placed by the rules."""
    specs = model_param_specs(cfg, tp)
    p_structs = param_structs(specs, rules, dtype=getattr(torch, cfg.param_dtype),
                              mode=mode)
    sdt = getattr(torch, opt_cfg.state_dtype)

    def moments():
        return param_structs(specs, rules, dtype=sdt, mode=mode)

    count = fake_struct(rules, (), torch.int32, (), mode=mode)
    return p_structs, {"m": moments(), "v": moments(), "count": count}


def batch_structs(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules,
                  mode=None):
    B, S = shape.global_batch, shape.seq_len

    def struct(name, shp, dtype):
        return fake_struct(rules, shp, dtype, BATCH_AXES[name], mode=mode)

    out = {"tokens": struct("tokens", (B, S), torch.long),
           "targets": struct("targets", (B, S), torch.long)}
    if cfg.encoder_layers:
        out["frames"] = struct("frames", (B, S, cfg.d_model), torch.bfloat16)
    elif cfg.frontend:
        out["extra_embeds"] = struct("extra_embeds",
                                     (B, cfg.frontend_len, cfg.d_model),
                                     torch.bfloat16)
    return out


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, *, tp: int = 1,
                      rules: ShardingRules | None = None) -> Callable:
    """``prefill_step(params, batch) -> [B, Vp]`` last-token logits.  An
    encoder-decoder model encodes ``batch["frames"]`` first; a decoder-only
    model takes ``batch["extra_embeds"]`` as its prefix where present."""
    if cfg.encoder_layers:
        def prefill_step(params, batch):
            with lm_mod.spmd(rules):
                enc_out = encdec_mod.encode(cfg, params, batch["frames"],
                                            tp=tp, rules=rules)
                x = encdec_mod.decode_train(cfg, params, batch["tokens"],
                                            enc_out, tp=tp, rules=rules)
                return lm_logits(x[:, -1:], params["lm_head"],
                                 lm_mod._dtype(cfg.compute_dtype))[:, 0]
    else:
        def prefill_step(params, batch):
            with lm_mod.spmd(rules):
                x, _aux = lm_mod.forward_hidden(
                    cfg, params, batch["tokens"],
                    extra_embeds=batch.get("extra_embeds"), tp=tp, rules=rules)
                return lm_mod.logits_from_hidden(cfg, params, x[:, -1:])[:, 0]

    return prefill_step


def prefill_batch_structs(cfg: ModelConfig, shape: ShapeConfig,
                          rules: ShardingRules, mode=None):
    structs = batch_structs(cfg, shape, rules, mode=mode)
    structs.pop("targets", None)
    return structs


def make_decode_step(cfg: ModelConfig, *, tp: int = 1,
                     rules: ShardingRules | None = None) -> Callable:
    if cfg.encoder_layers:
        def decode_step(params, cache, tokens, cache_len):
            return encdec_mod.encdec_decode_step(cfg, params, cache, tokens,
                                                 cache_len, tp=tp, rules=rules)
    else:
        def decode_step(params, cache, tokens, cache_len):
            return lm_mod.decode_step(cfg, params, cache, tokens, cache_len,
                                      tp=tp, rules=rules)

    return decode_step


def cache_structs(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules,
                  tp: int, mode=None):
    """Fake DTensors for the decode cache (no allocation)."""
    B = shape.global_batch
    dt = lm_mod._dtype(cfg.compute_dtype)
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    if cfg.encoder_layers:
        hp = lm_mod.head_plan(cfg, tp)
        nd, Kp, hd = cfg.num_layers, hp["Kp"], cfg.head_dim
        enc_len = min(shape.seq_len, ENC_LEN_CAP)
        shapes = {"k": (nd, B, shape.seq_len, Kp, hd),
                  "v": (nd, B, shape.seq_len, Kp, hd),
                  "xk": (nd, B, enc_len, Kp, hd),
                  "xv": (nd, B, enc_len, Kp, hd)}
        return {k: fake_struct(rules, shp, dt, kv_axes, mode=mode)
                for k, shp in shapes.items()}
    spec = lm_mod.cache_spec(cfg, B, shape.seq_len, tp, dtype=dt)
    return {kind: {name: fake_struct(rules, shp, dtype, axes, mode=mode)
                   for name, (shp, dtype, axes, _fill) in leaves.items()}
            for kind, leaves in spec.items()}


def decode_input_structs(cfg: ModelConfig, shape: ShapeConfig,
                         rules: ShardingRules, tp: int, mode=None):
    """(cache, tokens, cache_len): the cache half full, as an int."""
    B = shape.global_batch
    tokens = fake_struct(rules, (B, 1), torch.long, ("batch", "seq"), mode=mode)
    cache = cache_structs(cfg, shape, rules, tp, mode=mode)
    return cache, tokens, shape.seq_len // 2
