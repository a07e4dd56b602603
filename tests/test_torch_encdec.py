"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
JAX package's, on the CPU and in float32.

Parameters come from the JAX package's ``init_params`` (random, nonzero
RMS-norm scales) and cross as numpy through ``params_from_numpy``; frames
and tokens come from numpy.  ``encode``, ``decode_train`` and the greedy
``encdec_decode_step`` logits must agree within 2e-4 (the tolerance of the
JAX package's decode-vs-forward test, ``tests/test_archs.py``),
``encdec_loss`` within 1e-5, and so must the step factories.  Then that
test's counterpart for the port alone: each decode step's logits equal the
full forward's at the same position.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import encdec as jax_encdec
from repro.models.common import _iter_leaves as jax_iter_leaves
from repro.models.common import init_params as jax_init_params
from repro.runtime import steps as jax_steps
from repro_torch.configs.registry import get_config
from repro_torch.models import encdec
from repro_torch.models.common import _iter_leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import steps

NAME = "seamless-m4t-large-v2"
LOGIT_TOL, LOSS_TOL = 2e-4, 1e-5
B, SE, SD = 2, 16, 12


def _configs():
    return (dataclasses.replace(jax_get_config(NAME).smoke(), compute_dtype="float32"),
            dataclasses.replace(get_config(NAME).smoke(), compute_dtype="float32"))


def _shared_params(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_encdec.encdec_param_specs(jcfg, 1), jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)

    def norms(node, key=""):
        if isinstance(node, dict):
            return {k: norms(v, k) for k, v in node.items()}
        if key in ("ln1", "ln2", "ln_x", "final_norm"):
            return (0.2 * rng.standard_normal(node.shape)).astype(np.float32)
        return node

    tree = norms(tree)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, SE, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, SD))
    return frames, toks


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.fixture(scope="module")
def shared():
    jcfg, cfg = _configs()
    jp, tp = _shared_params(jcfg)
    frames, toks = _inputs(cfg)
    return jcfg, cfg, jp, tp, frames, toks


def test_param_specs_equal_the_jax_package():
    rows = [(p, s.shape, s.logical_axes, s.init, s.stddev)
            for p, s in _iter_leaves(steps.model_param_specs(get_config(NAME)))]
    want = [(p, s.shape, s.logical_axes, s.init, s.stddev)
            for p, s in jax_iter_leaves(jax_steps.model_param_specs(jax_get_config(NAME)))]
    assert rows == want


def test_encode_and_decode_train_match_jax(shared):
    jcfg, cfg, jp, tp, frames, toks = shared
    jenc = jax_encdec.encode(jcfg, jp, jnp.asarray(frames))
    tenc = encdec.encode(cfg, tp, torch.from_numpy(frames))
    _close(tenc, jenc, LOGIT_TOL)
    jx = jax_encdec.decode_train(jcfg, jp, jnp.asarray(toks), jenc)
    tx = encdec.decode_train(cfg, tp, torch.from_numpy(toks), tenc)
    _close(tx @ tp["lm_head"], jnp.einsum("bsd,dv->bsv", jx, jp["lm_head"]), LOGIT_TOL)


def test_encdec_loss_matches_jax(shared):
    jcfg, cfg, jp, tp, frames, toks = shared
    targets = np.roll(toks, -1, axis=1)
    jl, jm = jax_encdec.encdec_loss(jcfg, jp, {"frames": jnp.asarray(frames),
                                               "tokens": jnp.asarray(toks),
                                               "targets": jnp.asarray(targets)})
    tl, tm = encdec.encdec_loss(cfg, tp, {"frames": torch.from_numpy(frames),
                                          "tokens": torch.from_numpy(toks),
                                          "targets": torch.from_numpy(targets)})
    assert set(tm) == set(jm) == {"ce_loss", "loss"}
    assert abs(float(tl) - float(jl)) <= LOSS_TOL


def test_decode_steps_and_cache_match_jax(shared):
    """Greedy decode from the first token: each step's logits and every
    cache leaf (self K/V written in place, static cross K/V)."""
    jcfg, cfg, jp, tp, frames, toks = shared
    jenc = jax_encdec.encode(jcfg, jp, jnp.asarray(frames))
    tenc = encdec.encode(cfg, tp, torch.from_numpy(frames))
    jcache = jax_encdec.init_encdec_cache(jcfg, jp, jenc, max_seq=SD + 4)
    tcache = encdec.init_encdec_cache(cfg, tp, tenc, SD + 4)
    tok = toks[:, :1]
    for t in range(SD):
        jl, jcache = jax_encdec.encdec_decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                                   jnp.int32(t))
        tl, same = encdec.encdec_decode_step(cfg, tp, tcache, torch.from_numpy(tok), t)
        assert same is tcache
        _close(tl, jl, LOGIT_TOL)
        tok = np.array(jnp.argmax(jl[:, :, : cfg.vocab_size], axis=-1))
    assert sorted(tcache) == sorted(jcache)
    for name, want in jcache.items():
        assert tuple(tcache[name].shape) == want.shape, name
        _close(tcache[name], want, LOGIT_TOL)


def test_step_factories_match_jax(shared):
    jcfg, cfg, jp, tp, frames, toks = shared
    want = jax_steps.make_prefill_step(jcfg)(jp, {"frames": jnp.asarray(frames),
                                                  "tokens": jnp.asarray(toks)})
    got = steps.make_prefill_step(cfg)(tp, {"frames": torch.from_numpy(frames),
                                            "tokens": torch.from_numpy(toks)})
    assert got.shape == (B, cfg.padded_vocab(1))
    _close(got, want, LOGIT_TOL)
    jenc = jax_encdec.encode(jcfg, jp, jnp.asarray(frames))
    tenc = encdec.encode(cfg, tp, torch.from_numpy(frames))
    jcache = jax_encdec.init_encdec_cache(jcfg, jp, jenc, max_seq=8)
    tcache = encdec.init_encdec_cache(cfg, tp, tenc, 8)
    want, _ = jax_steps.make_decode_step(jcfg)(jp, jcache, jnp.asarray(toks[:, :1]),
                                               jnp.int32(0))
    got, _ = steps.make_decode_step(cfg)(tp, tcache, torch.from_numpy(toks[:, :1]), 0)
    _close(got, want, LOGIT_TOL)
    loss, _m = steps.loss_fn_for(cfg)(tp, {"frames": torch.from_numpy(frames),
                                           "tokens": torch.from_numpy(toks),
                                           "targets": torch.from_numpy(toks)})
    want, _m = jax_steps.loss_fn_for(jcfg, 1, None)(jp, {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(toks),
        "targets": jnp.asarray(toks)})
    assert abs(float(loss) - float(want)) <= LOSS_TOL


def test_encdec_decode_matches_forward():
    """The counterpart of tests/test_archs.py::test_encdec_decode_matches_forward:
    step-by-step decode against the cache equals the full forward."""
    _jcfg, cfg = _configs()
    frames, toks = _inputs(cfg, seed=4)
    _jp, params = _shared_params(_jcfg, seed=5)
    enc_out = encdec.encode(cfg, params, torch.from_numpy(frames))
    x = encdec.decode_train(cfg, params, torch.from_numpy(toks), enc_out)
    full_logits = x @ params["lm_head"]
    cache = encdec.init_encdec_cache(cfg, params, enc_out, SD + 4)
    for t in range(SD):
        logits, cache = encdec.encdec_decode_step(
            cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        assert float((logits[:, 0] - full_logits[:, t]).abs().max()) < LOGIT_TOL, t


def test_decode_step_refuses_a_full_cache(shared):
    _jcfg, cfg, _jp, tp, frames, toks = shared
    cache = encdec.init_encdec_cache(cfg, tp, encdec.encode(cfg, tp, torch.from_numpy(frames)), 2)
    with pytest.raises(ValueError, match="full"):
        encdec.encdec_decode_step(cfg, tp, cache, torch.from_numpy(toks[:, :1]), 2)
