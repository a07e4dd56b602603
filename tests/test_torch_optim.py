"""The port's training substrates (data pipeline, AdamW, schedule,
gradient compression) against the JAX package's, on the CPU.

The counterparts of ``tests/test_substrates.py``'s data, optimizer and
compression cases run against the port; beside them, the same inputs go
through both packages: the Philox token stream must be equal bit for bit,
a learning rate within one float32 ulp (the cosine may round apart), one
AdamW step within 1e-6, and the compressors' wire trees and residuals
within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import source_for as jax_source_for
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_compression
from repro.optim.schedule import constant as jax_constant
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import (
    DataPipeline,
    SyntheticLM,
    emit_details_for,
    source_for,
)
from repro_torch.optim import adamw, compression
from repro_torch.optim.schedule import constant, warmup_cosine

# -- data: the counterparts ---------------------------------------------------


def test_synthetic_stream_deterministic_and_seekable():
    src = SyntheticLM(vocab_size=1000, seq_len=16, global_batch=4, seed=3)
    b5 = src.batch(5)
    again = SyntheticLM(vocab_size=1000, seq_len=16, global_batch=4, seed=3).batch(5)
    np.testing.assert_array_equal(b5["tokens"], again["tokens"])
    assert b5["tokens"].shape == (4, 16)
    assert (b5["tokens"] < 1000).all()
    np.testing.assert_array_equal(b5["targets"][:, :-1], b5["tokens"][:, 1:])
    assert not np.array_equal(b5["tokens"], src.batch(6)["tokens"])


def test_pipeline_prefetch_consistent():
    src = SyntheticLM(vocab_size=100, seq_len=8, global_batch=2)
    pipe = DataPipeline(src, device="cpu")
    pipe.prefetch(0)
    b0 = pipe.get(0)
    assert isinstance(b0["tokens"], torch.Tensor) and b0["tokens"].device.type == "cpu"
    np.testing.assert_array_equal(b0["tokens"].numpy(), src.batch(0)["tokens"])


def test_pipeline_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DataPipeline(SyntheticLM(vocab_size=10, seq_len=4, global_batch=1))


def test_emit_adapter_terminates():
    src = SyntheticLM(vocab_size=10, seq_len=4, global_batch=1)
    details = emit_details_for(src, num_steps=3)
    state = details.initial_state()
    seen = []
    while True:
        item, state = details.create(state)
        if item is None:
            break
        seen.append(item[0])
    assert seen == [0, 1, 2]


# -- data: against the JAX package ------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (7, 1 << 12), (11, 999)])
def test_philox_stream_equals_jax_bit_for_bit(seed, step):
    kw = dict(vocab_size=32000, seq_len=33, global_batch=3, seed=seed)
    port, ref = SyntheticLM(**kw).batch(step), JaxSyntheticLM(**kw).batch(step)
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(port[k], ref[k])


@pytest.mark.parametrize("name", ["yi-9b", "recurrentgemma-2b", "internvl2-2b"])
def test_source_for_equals_jax(name):
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.configs.registry import get_config as jax_get_config

    port = source_for(get_config(name + "-smoke"), ShapeConfig("s", 16, 2, "train"), 4)
    ref = jax_source_for(jax_get_config(name + "-smoke"), JaxShape("s", 16, 2, "train"), 4)
    assert vars(port) == vars(ref)
    for k, v in ref.batch(2).items():
        np.testing.assert_array_equal(port.batch(2)[k], v)


# -- optimizer: the counterparts --------------------------------------------------


def test_adamw_reduces_quadratic_loss():
    cfg = adamw.AdamWConfig(weight_decay=0.0, clip_norm=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_state(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw of sum(w^2)
        params, state, _m = adamw.apply_updates(params, grads, state, cfg,
                                                torch.tensor(0.05))
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_grad_clipping_bounds_update():
    cfg = adamw.AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    state = adamw.init_state(params, cfg)
    grads = {"w": torch.tensor([1e6, -1e6, 1e6])}
    _p, _s, metrics = adamw.apply_updates(params, grads, state, cfg,
                                          torch.tensor(0.1))
    assert float(metrics["grad_norm"]) > 1e5  # raw norm reported


def test_schedule_shape():
    lrs = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10, total_steps=100))
           for s in range(100)]
    assert lrs[0] < 0.2
    assert abs(max(lrs) - 1.0) < 1e-6
    assert lrs[-1] < 0.2
    assert np.argmax(lrs) <= 11


# -- optimizer: against the JAX package --------------------------------------------


@pytest.mark.parametrize("peak,warm,total", [(1.0, 10, 100), (3e-4, 2, 3),
                                             (3e-4, 10, 20), (1e-3, 6, 60)])
def test_learning_rate_within_one_ulp_of_jax(peak, warm, total):
    for s in range(total + 3):
        want = np.float32(jax_warmup_cosine(jnp.int32(s), peak_lr=peak,
                                            warmup_steps=warm, total_steps=total))
        got = warmup_cosine(s, peak_lr=peak, warmup_steps=warm, total_steps=total)
        assert got.dtype == torch.float32
        assert abs(np.float32(got.item()) - want) <= np.spacing(want), s
    assert np.float32(constant(5, peak_lr=peak).item()) == np.float32(
        jax_constant(jnp.int32(5), peak_lr=peak))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0, 1e3])
def test_adamw_step_equals_jax(state_dtype, clip):
    """Two steps from the same params, grads and state: every leaf within
    1e-6 (bf16 moments: within one bf16 rounding of the same f32 value)."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32),
                  "d": rng.standard_normal((3, 2, 2)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32),
                          tree) for _ in range(2)]
    cfg_kw = dict(clip_norm=clip, state_dtype=state_dtype)
    jcfg, cfg = jax_adamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jax_adamw.init_state(jp, jcfg)
    tp = adamw.tree_map(lambda x: torch.from_numpy(x.copy()), tree)
    ts = adamw.init_state(tp, cfg)
    for i, g in enumerate(grads):
        lr = 0.01 * (i + 1)
        jp, js, jm = jax_adamw.apply_updates(jp, jax.tree.map(jnp.asarray, g), js,
                                             jcfg, jnp.float32(lr))
        tp, ts, tm = adamw.apply_updates(
            tp, adamw.tree_map(lambda x: torch.from_numpy(x.copy()), g), ts, cfg,
            torch.tensor(lr, dtype=torch.float32))
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), abs=1e-5)
    assert int(ts["count"]) == int(js["count"]) == 2
    atol = 1e-6 if state_dtype == "float32" else 2e-2
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for g_leaf, w_leaf in zip(adamw.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g_leaf.float().numpy(),
                                       np.asarray(w_leaf, np.float32), atol=atol)
    np.testing.assert_allclose(
        float(adamw.global_norm(tp)),
        float(jax_adamw.global_norm(jp)), rtol=1e-6)


def test_tree_order_is_jax_flatten_order():
    tree = {"z": 1, "a": {"y": 2, "b": 3}, "m": 4}
    assert adamw.tree_leaves(tree) == jax.tree.leaves(tree) == [3, 2, 4, 1]
    assert adamw.tree_leaves(adamw.tree_map(lambda v: v * 10, tree)) == [30, 20, 40, 10]


# -- gradient compression ------------------------------------------------------------


@given(mode=st.sampled_from(["bf16", "int8"]), seed=st.integers(0, 20))
@settings(max_examples=10, deadline=None)
def test_compression_error_feedback_converges(mode, seed):
    """Sum of (decompressed + carried error) over steps == sum of true grads."""
    rng = np.random.default_rng(seed)
    g_true = [rng.standard_normal((4, 8)).astype(np.float32) for _ in range(20)]
    err = compression.init_error_feedback({"w": torch.zeros((4, 8))})
    applied = np.zeros((4, 8), np.float32)
    for g in g_true:
        wire, meta, err = compression.compress({"w": torch.from_numpy(g)}, err, mode)
        deq = compression.decompress(wire, meta, mode)
        applied += deq["w"].numpy()
    np.testing.assert_allclose(applied + err["w"].numpy(), np.sum(g_true, axis=0),
                               atol=1e-2)


def test_compression_wire_size():
    g = {"w": torch.zeros((64, 128), dtype=torch.float32)}
    err = compression.init_error_feedback(g)
    wire_b, _, _ = compression.compress(g, err, "bf16")
    assert compression.wire_bytes(wire_b, "bf16") == 64 * 128 * 2
    wire_i, _, _ = compression.compress(g, err, "int8")
    assert compression.wire_bytes(wire_i, "int8") <= 64 * 128 * 1 + 64 * 4
    with pytest.raises(ValueError, match="unknown compression mode"):
        compression.compress(g, err, "fp4")


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compression_equals_jax(mode):
    rng = np.random.default_rng(1)
    grads = {"w": rng.standard_normal((6, 10)).astype(np.float32),
             "v": {"b": (100 * rng.standard_normal(7)).astype(np.float32)}}
    errs = jax.tree.map(lambda x: (1e-3 * rng.standard_normal(x.shape)).astype(np.float32),
                        grads)
    jw, jmeta, jerr = jax_compression.compress(jax.tree.map(jnp.asarray, grads),
                                               jax.tree.map(jnp.asarray, errs), mode)
    tw, tmeta, terr = compression.compress(
        adamw.tree_map(torch.from_numpy, grads), adamw.tree_map(torch.from_numpy, errs),
        mode)
    jdeq = jax_compression.decompress(jw, jmeta, mode)
    tdeq = compression.decompress(tw, tmeta, mode)
    for got, want in ((tdeq, jdeq), (terr, jerr)):
        for g_leaf, w_leaf in zip(adamw.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g_leaf.float().numpy(),
                                       np.asarray(w_leaf, np.float32), atol=1e-6)
    assert compression.wire_bytes(tw, mode) == jax_compression.wire_bytes(jw, mode)
