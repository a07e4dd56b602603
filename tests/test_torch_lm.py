"""The port's decoder-only LM (every block family: dense, recurrent, MoE,
xLSTM, and the ViT prefix) against the JAX package's, on the CPU.

Parameters come from the JAX package's ``init_params`` (with random, nonzero
RMS-norm scales, so that ``1 + scale`` is exercised, random RG-LRU gate
biases ``b_a``/``b_x`` and random xLSTM group-norm scales) and cross as
numpy through ``params_from_numpy``; tokens come from numpy.  Both run with
``compute_dtype="float32"``.  Logits must agree within 2e-4, the tolerance
of the JAX package's own decode-vs-forward test (``tests/test_archs.py``).
The single layers agree within 1e-5 (float32 products of at most a few
hundred terms, summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_config as jax_get_config
from repro.core.channels import padded_size as jax_padded_size
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models.common import _iter_leaves as jax_iter_leaves
from repro.models.common import count_params as jax_count_params
from repro.models.common import init_params as jax_init_params
from repro.runtime import steps as jax_steps
from repro_torch.configs import base
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.models import attention as port_attn
from repro_torch.models import layers as port_layers
from repro_torch.models import lm
from repro_torch.models.common import _iter_leaves, count_params, init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import steps

LOGIT_TOL = 2e-4
LAYER_TOL = 1e-5
DENSE = ["yi-9b", "phi3-medium-14b", "command-r-35b", "gemma3-4b"]
PORTED = DENSE + ["recurrentgemma-2b", "olmoe-1b-7b", "llama4-maverick-400b-a17b",
                  "xlstm-350m"]
# Prompt lengths: recurrentgemma's is longer than its smoke window of 32,
# so the local layers' ring wraps.
PROMPT_LEN = {"recurrentgemma-2b": 46}


def _configs(name):
    jcfg = dataclasses.replace(jax_get_config(name).smoke(), compute_dtype="float32")
    cfg = dataclasses.replace(get_config(name).smoke(), compute_dtype="float32")
    return jcfg, cfg


def _shared_params(jcfg, seed=0):
    """JAX init_params with random norm scales -> (jax tree, port tree)."""
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_lm.lm_param_specs(jcfg, 1), jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)

    def norms(node, key=""):
        if isinstance(node, dict):
            return {k: norms(v, k) for k, v in node.items()}
        if key in ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "b_a", "b_x",
                   "norm"):
            return (0.2 * rng.standard_normal(node.shape)).astype(np.float32)
        return node

    tree = norms(tree)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _close(port: torch.Tensor, ref, atol: float) -> None:
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


# -- configs ------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_configs_equal_the_jax_package(name, smoke):
    """Every field the JAX package has is equal; the fields only the port
    has (latent attention, YaRN, leading layers, ...) keep their defaults,
    which are the JAX package's behaviour."""
    suffix = "-smoke" if smoke else ""
    port = dataclasses.asdict(get_config(name + suffix))
    theirs = dataclasses.asdict(jax_get_config(name + suffix))
    defaults = {f.name: f.default for f in dataclasses.fields(base.ModelConfig)}
    assert {k: v for k, v in port.items() if k in theirs} == theirs
    assert {k: v for k, v in port.items() if k not in theirs} == \
        {k: defaults[k] for k in port if k not in theirs}
    assert set(ARCHS) == set(JAX_ARCHS)


def test_config_helpers_equal_the_jax_package():
    for dt in ("float32", "bfloat16", "float16", "int32", "int8"):
        assert base.bytes_of(dt) == jax_base.bytes_of(dt)
    for n, m in ((1, 8), (92553, 16), (40, 16), (64000, 1), (0, 4)):
        assert base.padded_size(n, m) == jax_padded_size(n, m)
    with pytest.raises(ValueError):
        base.padded_size(3, 0)


# -- parameter specs and initialisation ------------------------------------------------


def _leaf_rows(leaves):
    return [(p, s.shape, s.logical_axes, s.init, s.stddev) for p, s in leaves]


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_param_specs_equal_the_jax_package_at_tp1(name):
    """Every config, the encoder-decoder through ``model_param_specs``."""
    specs = steps.model_param_specs(get_config(name))
    jspecs = jax_steps.model_param_specs(jax_get_config(name), 1)
    assert _leaf_rows(_iter_leaves(specs)) == _leaf_rows(jax_iter_leaves(jspecs))
    assert count_params(specs) == jax_count_params(jspecs)
    if not get_config(name).encoder_layers:
        assert lm.lm_param_specs(get_config(name)) == specs


def test_yi_9b_at_full_width_has_its_published_size():
    n = count_params(lm.lm_param_specs(get_config("yi-9b")))
    assert 8.8e9 < n < 8.9e9  # 17.7 GB in bf16


def test_recurrentgemma_2b_at_full_width_has_its_size():
    specs = lm.lm_param_specs(get_config("recurrentgemma-2b"))
    n = count_params(specs)
    assert 3.30e9 < n < 3.32e9  # 6.6 GB in bf16; untied embedding and head
    assert n == jax_count_params(
        jax_lm.lm_param_specs(jax_get_config("recurrentgemma-2b"), 1))
    assert set(specs["blocks"]) == {"rec", "local"}
    assert specs["blocks"]["rec"]["rec"]["rglru"]["lambda"].shape == (18, 2560)


@pytest.mark.parametrize("name, lo, hi", [
    ("olmoe-1b-7b", 6.9e9, 6.95e9),  # 13.8 GB in bf16
    ("llama4-maverick-400b-a17b", 3.9e11, 4.0e11),  # "400b"
    ("xlstm-350m", 2.5e8, 2.6e8),  # the config's 24 blocks; d_ff 0
    ("internvl2-2b", 1.85e9, 1.9e9),
    ("seamless-m4t-large-v2", 2.0e9, 2.05e9),
])
def test_other_families_at_full_width_have_their_size(name, lo, hi):
    n = count_params(steps.model_param_specs(get_config(name)))
    assert lo < n < hi


def test_init_params_is_seeded_per_leaf():
    specs = lm.lm_param_specs(get_config("yi-9b-smoke"))
    a = init_params(specs, 0, "cpu")
    b = init_params(specs, 0, "cpu")
    c = init_params(specs, 1, "cpu", torch.bfloat16)
    for (path, spec), x, y, z in zip(
            _iter_leaves(specs), *(jax.tree.leaves(t) for t in (a, b, c))):
        assert tuple(x.shape) == spec.shape and z.dtype == torch.bfloat16, path
        assert torch.equal(x, y), path
        if spec.init == "zeros":
            assert not x.any(), path
        else:
            assert not torch.equal(x, z.float()), path
    wq = a["blocks"]["attn"]["wq"]  # [layers, 64, 64], stddev 1/8
    assert abs(float(wq.std()) - 0.125) < 0.01
    assert not torch.equal(wq, a["blocks"]["attn"]["wk"])  # own generator each


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "llama4-maverick-400b-a17b",
                                  "xlstm-350m", "seamless-m4t-large-v2"])
def test_params_from_numpy_takes_every_family_key_for_key(name):
    """The MoE, xLSTM and encoder-decoder trees (``moe``, ``core/r``,
    ``encoder``/``decoder``/``cross`` subtrees) cross unchanged."""
    jspecs = jax_steps.model_param_specs(jax_get_config(name).smoke(), 1)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda sp: rng.standard_normal(sp.shape).astype(np.float32),
                        jspecs, is_leaf=lambda x: hasattr(x, "logical_axes"))
    out = params_from_numpy(tree, "cpu")
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(out)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_p, w) in zip(got, want):
        assert np.array_equal(g.numpy(), w), path
    assert (jax.tree.structure(jax.tree.map(lambda s: 0, steps.model_param_specs(
        get_config(name).smoke()))) == jax.tree.structure(jax.tree.map(lambda a: 0, out)))


def test_params_from_numpy_keeps_keys_and_values():
    tree = {"embed": np.arange(6, dtype=np.float32).reshape(3, 2),
            "blocks": {"attn": {"ln1": np.ones((2, 4), np.float32)}}}
    out = params_from_numpy(tree, "cpu", torch.bfloat16)
    assert out["embed"].dtype == torch.bfloat16
    assert torch.equal(out["embed"].float(), torch.arange(6.0).reshape(3, 2))
    assert out["blocks"]["attn"]["ln1"].shape == (2, 4)


# -- layers ------------------------------------------------------------------------------


def test_layers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    w = [rng.standard_normal(s, dtype=np.float32) * 0.1
         for s in ((64, 96), (64, 96), (96, 64))]
    _close(port_layers.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w),
                              torch.float32),
           jax_layers.swiglu(jnp.asarray(x), *map(jnp.asarray, w), jnp.float32),
           LAYER_TOL)
    emb = rng.standard_normal((50, 64), dtype=np.float32)
    toks = rng.integers(0, 50, (2, 5))
    _close(port_layers.embed_tokens(torch.from_numpy(emb), torch.from_numpy(toks),
                                    torch.float32),
           jax_layers.embed_tokens(jnp.asarray(emb), jnp.asarray(toks), jnp.float32),
           0.0)
    head = rng.standard_normal((64, 50), dtype=np.float32)
    for softcap in (0.0, 3.0):
        _close(port_layers.lm_logits(torch.from_numpy(x), torch.from_numpy(head),
                                     torch.float32, softcap),
               jax_layers.lm_logits(jnp.asarray(x), jnp.asarray(head), jnp.float32,
                                    softcap),
               LAYER_TOL)


@pytest.mark.parametrize("per_row", [False, True], ids=["positions_s", "positions_bs"])
def test_rope_matches_jax(per_row):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    pos = (rng.integers(0, 300, (2, 7)) if per_row else np.arange(7) + 11)
    _close(port_attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jax_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), LAYER_TOL)


def test_decode_attention_with_a_length_per_row_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 1, 8, 16), dtype=np.float32)
    ck, cv = (rng.standard_normal((3, 20, 2, 16), dtype=np.float32) for _ in "kv")
    lens = np.array([1, 13, 20])
    _close(port_attn.decode_attention(*map(torch.from_numpy, (q, ck, cv, lens))),
           jax_attn.decode_attention(*map(jnp.asarray, (q, ck, cv, lens))),
           LAYER_TOL)


# -- the model: forward, prefill, decode ---------------------------------------------


@pytest.mark.parametrize("name", PORTED)
def test_prefill_and_decode_logits_match_jax(name):
    jcfg, cfg = _configs(name)
    jp, tp = _shared_params(jcfg)
    B, S = 2, PROMPT_LEN.get(name, 33)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    jt = jnp.asarray(toks, jnp.int32)
    tt = torch.from_numpy(toks)

    jx, jaux = jax_lm.forward_hidden(jcfg, jp, jt)
    tx, taux = lm.forward_hidden(cfg, tp, tt)
    _close(lm.logits_from_hidden(cfg, tp, tx),
           jax_lm.logits_from_hidden(jcfg, jp, jx), LOGIT_TOL)
    _aux_close(taux, jaux)

    jl, jcache = jax_lm.prefill(jcfg, jp, jt[:, :S - 1], max_seq=S + 8)
    tl, tcache = lm.prefill(cfg, tp, tt[:, :S - 1], S + 8)
    _close(tl, jl, LOGIT_TOL)
    _caches_close(tcache, jcache)

    # one step at a common length (int), then per-row lengths ([B] tensor)
    jd, jcache = jax_lm.decode_step(jcfg, jp, jcache, jt[:, S - 1:],
                                    jnp.int32(S - 1))
    td, same = lm.decode_step(cfg, tp, tcache, tt[:, S - 1:], S - 1)
    assert same is tcache  # every leaf written in place
    _close(td, jd, LOGIT_TOL)
    _caches_close(tcache, jcache)
    nxt = np.array(jnp.argmax(jd[:, 0, : cfg.vocab_size], axis=-1))[:, None]
    lens = np.array([S, S])
    jd2, jcache = jax_lm.decode_step(jcfg, jp, jcache,
                                     jnp.asarray(nxt, jnp.int32),
                                     jnp.asarray(lens, jnp.int32))
    td2, tcache = lm.decode_step(cfg, tp, tcache, torch.from_numpy(nxt),
                                 torch.from_numpy(lens))
    _close(td2, jd2, LOGIT_TOL)
    _caches_close(tcache, jcache)


def _aux_close(taux, jaux) -> None:
    """The MoE aux values, summed over the layers: keys equal, values within
    1e-5 (float32 sums in another order)."""
    assert sorted(taux) == sorted(jaux)
    for key, want in jaux.items():
        assert abs(float(taux[key]) - float(want)) <= LAYER_TOL, (key, taux, jaux)


def _caches_close(tcache, jcache) -> None:
    """Every leaf (k/v; h/conv for rec; conv/C/n/m for mlstm; c/n/m/h for
    slstm) with its dtype and shape."""
    assert {k: sorted(v) for k, v in tcache.items()} == \
           {k: sorted(v) for k, v in jcache.items()}
    for kind, leaves in jcache.items():
        for name, want in leaves.items():
            got = tcache[kind][name]
            assert tuple(got.shape) == want.shape, (kind, name)
            assert str(got.dtype).split(".")[-1] == str(want.dtype), (kind, name)
            _close(got, want, LOGIT_TOL)


def test_step_factories_match_jax():
    jcfg, cfg = _configs("yi-9b")
    jp, tp = _shared_params(jcfg, seed=2)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    want = jax_steps.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got = steps.make_prefill_step(cfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, cfg.padded_vocab(1))
    _close(got, want, LOGIT_TOL)
    _, tcache = lm.prefill(cfg, tp, torch.from_numpy(toks), 16)
    _, jcache = jax_lm.prefill(jcfg, jp, jnp.asarray(toks), 16)
    got, _ = steps.make_decode_step(cfg)(tp, tcache, torch.from_numpy(toks[:, :1]), 12)
    want, _ = jax_steps.make_decode_step(jcfg)(jp, jcache, jnp.asarray(toks[:, :1]),
                                               jnp.int32(12))
    _close(got, want, LOGIT_TOL)


def test_prefill_refuses_a_prompt_longer_than_the_cache():
    cfg = get_config("yi-9b-smoke")
    params = init_params(lm.lm_param_specs(cfg), 0, "cpu")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        lm.prefill(cfg, params, torch.zeros((1, 9), dtype=torch.int64), 8)


def test_recurrent_prefill_takes_a_prompt_longer_than_max_seq():
    """rec + local layers hold a fixed-size state and a window-long ring, so
    a prompt longer than max_seq is computed, as the JAX package does."""
    jcfg, cfg = _configs("recurrentgemma-2b")
    jp, tp = _shared_params(jcfg, seed=4)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 45))
    max_seq = 40  # > the window of 32, < the prompt
    jl, jcache = jax_lm.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_seq)
    tl, tcache = lm.prefill(cfg, tp, torch.from_numpy(toks), max_seq)
    _close(tl, jl, LOGIT_TOL)
    _caches_close(tcache, jcache)


def _moe_prefill_with_capacity_drops(arch):
    """At the full configs' capacity factor of 1.25 (the smoke configs are
    dropless) a prompt's tokens drop, and still the logits, the aux values
    and the prefill's cache agree; a decode step (S = 1) drops nothing."""
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=1.25)
                 for c in _configs(arch))
    jp, tp = _shared_params(jcfg, seed=6)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 40))
    jx, jaux = jax_lm.forward_hidden(jcfg, jp, jnp.asarray(toks, jnp.int32))
    tx, taux = lm.forward_hidden(cfg, tp, torch.from_numpy(toks))
    assert float(taux["moe_drop_fraction"]) > 0.0
    _aux_close(taux, jaux)
    _close(lm.logits_from_hidden(cfg, tp, tx), jax_lm.logits_from_hidden(jcfg, jp, jx),
           LOGIT_TOL)
    jl, jcache = jax_lm.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_seq=48)
    tl, tcache = lm.prefill(cfg, tp, torch.from_numpy(toks), 48)
    _close(tl, jl, LOGIT_TOL)
    _caches_close(tcache, jcache)
    nxt = np.array(jnp.argmax(jl[:, 0, : cfg.vocab_size], axis=-1))[:, None]
    jd, _ = jax_lm.decode_step(jcfg, jp, jcache, jnp.asarray(nxt, jnp.int32),
                               jnp.int32(40))
    td, _ = lm.decode_step(cfg, tp, tcache, torch.from_numpy(nxt), 40)
    _close(td, jd, LOGIT_TOL)


def test_moe_prefill_with_capacity_drops_matches_jax():
    """olmoe-1b-7b: top-8 of its experts, no shared expert."""
    _moe_prefill_with_capacity_drops("olmoe-1b-7b")


def test_maverick_prefill_with_capacity_drops_matches_jax():
    """llama4-maverick: top-1 with the shared expert, its MoE layers
    interleaved with dense ones."""
    _moe_prefill_with_capacity_drops("llama4-maverick-400b-a17b")


def test_extra_embeds_forward_matches_jax():
    """internvl2's ViT stub: F embeddings replace the first F positions,
    unscaled, in the forward and in the prefill step."""
    jcfg, cfg = _configs("internvl2-2b")
    jp, tp = _shared_params(jcfg, seed=7)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 24))
    extra = rng.standard_normal((2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    jx, _ = jax_lm.forward_hidden(jcfg, jp, jnp.asarray(toks),
                                  extra_embeds=jnp.asarray(extra))
    tx, aux = lm.forward_hidden(cfg, tp, torch.from_numpy(toks),
                                extra_embeds=torch.from_numpy(extra))
    assert aux == {}
    _close(lm.logits_from_hidden(cfg, tp, tx), jax_lm.logits_from_hidden(jcfg, jp, jx),
           LOGIT_TOL)
    plain, _ = lm.forward_hidden(cfg, tp, torch.from_numpy(toks))
    assert not torch.allclose(plain, tx)  # the prefix changed the forward
    batch = {"tokens": toks, "extra_embeds": extra}
    want = jax_steps.make_prefill_step(jcfg)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = steps.make_prefill_step(cfg)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "xlstm-350m", "internvl2-2b"])
def test_lm_loss_matches_jax(name):
    """Loss and metrics: CE, and for MoE models 0.01 * lb + 0.001 * z on
    top with the three aux values reported; internvl2 with its prefix."""
    jcfg, cfg = _configs(name)
    jp, tp = _shared_params(jcfg, seed=8)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": toks[:, :32], "targets": toks[:, 1:]}
    if cfg.frontend_len:
        batch["extra_embeds"] = rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    jl, jm = jax_lm.lm_loss(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = lm.lm_loss(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(tm) == sorted(jm)
    for key, want in jm.items():
        assert abs(float(tm[key]) - float(want)) <= LAYER_TOL, (key, tm, jm)
    assert abs(float(tl) - float(jl)) <= LAYER_TOL


def test_xlstm_prefill_takes_a_prompt_its_chunk_does_not_divide():
    """A 70-token prompt at the mLSTM's chunk of 64: the JAX prefill raises
    (its chunkwise form needs chunk | S); the port's runs a last chunk of 6
    and equals the JAX package's prefill of 64 tokens followed by 6 decode
    steps, logits and every cache leaf within 2e-4."""
    jcfg, cfg = _configs("xlstm-350m")
    jp, tp = _shared_params(jcfg, seed=9)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 70))
    with pytest.raises(ValueError, match="not divisible"):
        jax_lm.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_seq=80)
    jl, jcache = jax_lm.prefill(jcfg, jp, jnp.asarray(toks[:, :64], jnp.int32), max_seq=80)
    for t in range(64, 70):
        jl, jcache = jax_lm.decode_step(jcfg, jp, jcache,
                                        jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                        jnp.int32(t))
    tl, tcache = lm.prefill(cfg, tp, torch.from_numpy(toks), 80)
    _close(tl, jl, LOGIT_TOL)
    _caches_close(tcache, jcache)
