"""The port's checkpoints: the counterparts of ``tests/test_substrates.py``'s
checkpoint cases, restores across the two packages in both directions
(every leaf equal, the meta check passing), bfloat16 leaves kept by type
and bit, and ``config_hash`` equal for a port config and its JAX twin."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint.checkpoint import config_hash as jax_config_hash
from repro.configs.registry import get_config as jax_get_config
from repro_torch.checkpoint.checkpoint import CheckpointManager, config_hash
from repro_torch.configs.registry import get_config


def _state(rng):
    return {"params": {"w": rng.standard_normal((2, 3)).astype(np.float32),
                       "blocks": {"rec": {"a": rng.standard_normal(4).astype(np.float32)}}},
            "opt": {"count": np.int32(7),
                    "m": {"w": rng.standard_normal((2, 3)).astype(np.float32)}}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# -- the counterparts ------------------------------------------------------------------


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"count": torch.tensor(7, dtype=torch.int32)}}
    for step in (1, 2, 3, 4):
        mgr.save(step, state, {"config_hash": "abc"})
    assert mgr.all_steps() == [3, 4]  # gc kept the last 2
    step, restored, manifest = mgr.restore(device="cpu")
    assert step == 4
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    count = restored["opt"]["count"]
    assert count.dtype == torch.int32 and count.shape == () and int(count) == 7
    assert manifest["config_hash"] == "abc"


def test_checkpoint_meta_mismatch_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(2)}, {"config_hash": "A"})
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(device="cpu", expect_meta={"config_hash": "B"})


def test_checkpoint_async_and_atomic(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(5, {"w": torch.ones(4)})
    mgr.wait()
    assert mgr.latest_step() == 5
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_save_async_copies_before_returning(tmp_path):
    """The train step updates its tensors in place: what an async save
    writes is the state at the call, whatever happens after."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.ones(1000)
    mgr.save_async(1, {"w": w})
    w.mul_(3.0)
    mgr.wait()
    _s, restored, _m = mgr.restore(device="cpu")
    assert torch.equal(restored["w"], torch.ones(1000))


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mgr.restore()


# -- across the two packages -------------------------------------------------------------


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    state = _state(rng)
    JaxCheckpointManager(str(tmp_path)).save(
        3, jax.tree.map(jnp.asarray, state), {"config_hash": "h1"})
    step, got, manifest = CheckpointManager(str(tmp_path)).restore(
        device="cpu", expect_meta={"config_hash": "h1"})
    assert step == 3 and manifest["config_hash"] == "h1"
    want, have = _flat(state), _flat(got)
    assert want.keys() == have.keys()
    for k, v in want.items():
        assert have[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(have[k].numpy(), v)


def test_port_checkpoint_restores_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    state = _state(rng)
    CheckpointManager(str(tmp_path)).save(4, _torch_tree(state), {"config_hash": "h2"})
    step, got, manifest = JaxCheckpointManager(str(tmp_path)).restore(
        expect_meta={"config_hash": "h2"})
    assert step == 4 and manifest["config_hash"] == "h2"
    want, have = _flat(state), _flat(got)
    assert want.keys() == have.keys()
    for k, v in want.items():
        assert np.asarray(have[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(have[k]), v)
    with pytest.raises(ValueError, match="mismatch"):
        JaxCheckpointManager(str(tmp_path)).restore(expect_meta={"config_hash": "x"})


# -- bfloat16 leaves -------------------------------------------------------------------------


def test_bf16_state_roundtrips_in_the_port(tmp_path):
    from repro_torch.optim import adamw

    params = {"w": torch.randn(3, 5, generator=torch.Generator().manual_seed(0))}
    opt = adamw.init_state(params, adamw.AdamWConfig(state_dtype="bfloat16"))
    opt["m"]["w"].copy_(torch.randn(3, 5, generator=torch.Generator().manual_seed(1)))
    state = {"params": {"w": params["w"].to(torch.bfloat16)}, "moments": opt}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    manifest = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert manifest["dtypes"]["/moments/m/w"] == "bfloat16"
    _s, got, _m = mgr.restore(device="cpu")
    for k, v in _flat(state).items():
        have = _flat(got)[k]
        assert have.dtype == v.dtype, k
        assert torch.equal(have, v), k


def test_jax_written_bf16_leaf_is_read_bit_for_bit(tmp_path):
    """The JAX package's own restore gives such a leaf back as raw |V2
    records (ROADMAP §3); the port rebuilds the bfloat16 bits."""
    rng = np.random.default_rng(2)
    leaf = rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16)
    JaxCheckpointManager(str(tmp_path)).save(1, {"m": jnp.asarray(leaf)})
    _s, jax_got, _m = JaxCheckpointManager(str(tmp_path)).restore()
    assert np.asarray(jax_got["m"]).dtype == np.dtype("V2")  # the reference's fault
    _s, got, _m = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert got["m"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["m"].view(torch.int16).numpy(),
                                  leaf.view(np.int16))


# -- config_hash ---------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["yi-9b", "recurrentgemma-2b"])
@pytest.mark.parametrize("compute", [None, "float32"])
def test_config_hash_equals_jax(name, compute):
    cfg, jcfg = get_config(name + "-smoke"), jax_get_config(name + "-smoke")
    if compute:
        cfg = dataclasses.replace(cfg, compute_dtype=compute)
        jcfg = dataclasses.replace(jcfg, compute_dtype=compute)
    assert repr(cfg) == repr(jcfg)
    assert config_hash(cfg) == jax_config_hash(jcfg)
    assert config_hash(get_config(name)) == jax_config_hash(jax_get_config(name))
