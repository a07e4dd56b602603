"""``remat_policy="dots"`` in the port against ``"nothing"`` and against the
JAX package's ``dots_with_no_batch_dims_saveable``, on the CPU.

* Bits: at smoke size in float32, loss and every gradient under ``"dots"``
  equal those under ``"nothing"`` bit for bit, and the backward runs as
  many fewer ``aten.mm`` as the policy saved (more than none), less one a
  block whose last op is a product: ``"nothing"``'s recompute stops before
  that product, which no backward reads.
* Against JAX: under ``"dots"`` the port's loss and gradients are within
  1e-4 (the trainer parity's tolerance) of ``jax.grad`` of the JAX loss
  under ``"dots"``, from the same parameters and batch.
* Saved set: for each block kind, the element counts of the products the
  port's policy saves hold every non-argument residual that JAX saves for
  the same block (``saved_residuals``; the positions constant is an input,
  as in the port).  The one extra is named: the block's last product (the
  MLP's ``w_down``, or the xLSTM core's), whose output feeds only the
  block's output, [B, S, D]; JAX does not keep it because no backward
  reads it.  JAX keeps ``silu(g)`` where the port keeps ``g``: as many
  elements.  The MoE block keeps exactly JAX's set.
* An unknown policy name is an error (the JAX package reads it as
  ``"nothing"``).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from repro.configs.registry import get_config as jax_get_config
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro.models.common import init_params as jax_init_params
from repro.runtime import steps as jax_steps
from repro_torch.configs.registry import get_config
from repro_torch.models import encdec, lm
from repro_torch.models.common import init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.runtime import steps

FAMILIES = ["yi-9b", "recurrentgemma-2b", "olmoe-1b-7b", "xlstm-350m",
            "seamless-m4t-large-v2"]
JAX_TOL = 1e-4
B, S, S_ENC = 2, 32, 24


def _cfgs(name, policy="dots"):
    over = dict(compute_dtype="float32", remat_policy=policy)
    return (dataclasses.replace(jax_get_config(name).smoke(), **over),
            dataclasses.replace(get_config(name).smoke(), **over))


def _batch(cfg, rng):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in lm.DOTS
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg, params, batch):
    """(loss, gradients, products saved, products run in the backward)."""
    saved = []
    policy = lm.dots_policy

    def record(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == lm.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            mats = [a for a in args if isinstance(a, torch.Tensor)][-2:]
            saved.append(mats[0].shape[0] * mats[1].shape[1])
        return out

    leaves = adamw.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    lm.dots_policy = record
    try:
        loss, _m = steps.loss_fn_for(cfg)(params, batch)
        with _CountMM() as count:
            grads = torch.autograd.grad(loss, leaves)
    finally:
        lm.dots_policy = policy
        for leaf in leaves:
            leaf.requires_grad_(False)
    return loss.detach(), grads, saved, count.mm


@pytest.mark.parametrize("name", FAMILIES)
def test_dots_gives_the_bits_of_nothing(name):
    _jcfg, cfg = _cfgs(name)
    params = init_params(steps.model_param_specs(cfg), 0, "cpu")
    batch = _torch_batch(_batch(cfg, np.random.default_rng(1)))
    loss0, grads0, saved0, mm0 = _loss_and_grads(
        dataclasses.replace(cfg, remat_policy="nothing"), params, batch)
    loss1, grads1, saved1, mm1 = _loss_and_grads(cfg, params, batch)
    assert saved0 == [] and saved1
    ending_in_a_product = cfg.encoder_layers + sum(
        kind != "moe" for kind in cfg.pattern_for_layers)
    assert mm0 - mm1 == len(saved1) - ending_in_a_product
    assert loss0.numpy().tobytes() == loss1.numpy().tobytes()
    for g0, g1 in zip(grads0, grads1, strict=True):
        assert g0.numpy().tobytes() == g1.numpy().tobytes()


@pytest.mark.parametrize("name", ["yi-9b", "seamless-m4t-large-v2"])
def test_dots_against_jax_grad_under_dots(name):
    jcfg, cfg = _cfgs(name)
    jparams = jax_init_params(jax_steps.model_param_specs(jcfg, 1),
                              jax.random.PRNGKey(0), jnp.float32)
    batch = _batch(cfg, np.random.default_rng(2))
    jloss_fn = jax_steps.loss_fn_for(jcfg, 1, None)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, b)[0]))(jparams, {k: jnp.asarray(v)
                                                   for k, v in batch.items()})
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    loss, grads, saved, _mm = _loss_and_grads(cfg, params, _torch_batch(batch))
    assert saved
    assert abs(loss.item() - float(jloss)) <= JAX_TOL
    want = adamw.tree_leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrads), "cpu"))
    for g, w in zip(grads, want, strict=True):
        assert float((g - w).abs().max()) <= JAX_TOL


# -- the saved set, block by block ------------------------------------------------

# (config, block kind, extra products the port keeps: element counts)
BLOCKS = [("yi-9b", "attn", 1), ("recurrentgemma-2b", "local", 1),
          ("recurrentgemma-2b", "rec", 1), ("olmoe-1b-7b", "moe", 0),
          ("xlstm-350m", "mlstm", 1), ("xlstm-350m", "slstm", 1),
          ("seamless-m4t-large-v2", "encoder", 1),
          ("seamless-m4t-large-v2", "decoder", 1)]


def _jax_saved(fn, *args) -> list[int]:
    policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    return [int(np.prod(aval.shape))
            for aval, where in saved_residuals(jax.checkpoint(fn, policy=policy), *args)
            if not where.startswith(("from the argument", "from a constant"))]


def _port_saved(cfg, fn, *args) -> list[int]:
    saved = []
    policy = lm.dots_policy

    def record(ctx, op, *a, **kw):
        out = policy(ctx, op, *a, **kw)
        if out == lm.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            mats = [t for t in a if isinstance(t, torch.Tensor)][-2:]
            saved.append(mats[0].shape[0] * mats[1].shape[1])
        return out

    lm.dots_policy = record
    try:
        outs = checkpoint(fn, *args, use_reentrant=False, **lm._remat_policy(cfg))
        sum(o.sum() for o in outs).backward()
    finally:
        lm.dots_policy = policy
    return saved


@pytest.mark.parametrize("name,kind,extra", BLOCKS, ids=[b[1] for b in BLOCKS])
def test_saved_products_hold_every_jax_residual(name, kind, extra):
    jcfg, cfg = _cfgs(name)
    jparams = jax_init_params(jax_steps.model_param_specs(jcfg, 1),
                              jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    part = {"encoder": jparams.get("encoder"), "decoder": jparams.get("decoder")}
    stack = part[kind]["blocks"] if kind in part else jparams["blocks"][kind]
    jp = jax.tree_util.tree_map(lambda a: a[0], stack)
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    p = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), p)
    jpos, jpe = jnp.arange(S), jnp.arange(S_ENC)
    pos, pe = torch.arange(S), torch.arange(S_ENC)
    tx = torch.from_numpy(x).requires_grad_(True)
    te = torch.from_numpy(enc).requires_grad_(True)
    if kind == "encoder":
        want = _jax_saved(lambda p, x: jax_encdec._enc_block(jcfg, p, x, jpos, 1, None),
                          jp, jnp.asarray(x))
        got = _port_saved(cfg, lambda x, p: (encdec._enc_block(cfg, p, x, pos),), tx, p)
    elif kind == "decoder":
        want = _jax_saved(lambda p, x, e: jax_encdec._dec_block(
            jcfg, p, x, e, jpos, jpe, 1, None)[0], jp, jnp.asarray(x), jnp.asarray(enc))
        got = _port_saved(cfg, lambda x, p, e: (encdec._dec_block(
            cfg, p, x, e, pos, pe)[0],), tx, p, te)
    else:
        def jfn(p, x):
            y, _cache, aux = jax_lm.apply_block(jcfg, kind, p, x, jpos)
            return y, aux

        def fn(x, p):
            y, _state, aux = lm.apply_block(cfg, kind, p, x, pos)
            return (y, *aux.values())

        want = _jax_saved(jfn, jp, jnp.asarray(x))
        got = _port_saved(cfg, fn, tx, p)
    assert want
    missing = collections.Counter(want) - collections.Counter(got)
    assert not missing, (want, got)
    extras = collections.Counter(got) - collections.Counter(want)
    assert sorted(extras.elements()) == [B * S * cfg.d_model] * extra, (want, got)


def test_unknown_policy_is_an_error():
    cfg = dataclasses.replace(get_config("yi-9b").smoke(), remat_policy="everything")
    params = init_params(steps.model_param_specs(cfg), 0, "cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="remat_policy 'everything'"):
        lm.lm_loss(cfg, params, {"tokens": toks, "targets": toks})
