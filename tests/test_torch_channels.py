"""The port's sharding rules (``repro_torch.core.channels``) against the JAX
package's: the cases of ``tests/test_channels.py`` and its property test,
and, for every runnable cell at tp = 16 on both production meshes, the
partition spec of every parameter leaf (and every decode-cache leaf) of
every family, compared entry for entry (exact: the specs are names).

The rule engine reads only axis names and sizes, so no process group is
needed: the port's rules run over a ``MeshShape``, the JAX package's over
a stand-in with ``axis_names`` and a devices array of the mesh's shape.
"""

import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

from repro.configs.registry import all_cells as jax_all_cells
from repro.core import channels as jax_channels
from repro.models import lm as jax_lm
from repro.runtime import steps as jax_steps
from repro_torch.configs.registry import all_cells
from repro_torch.core.channels import (
    Channel,
    MeshShape,
    ShardingRules,
    decode_rules,
    long_context_rules,
    padded_size,
    rules_for_shape_kind,
    training_rules,
)
from repro_torch.models import lm
from repro_torch.models.common import ParamSpec
from repro_torch.runtime import steps

RULES_16x16 = [
    ("batch", ("pod", "data")),
    ("batch", ("data",)),
    ("seq_sp", ("model",)),
    ("vocab", ("model",)),
    ("d_ff", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("kv_seq", ("model",)),
    ("d_model_fsdp", ("pod", "data")),
    ("d_model_fsdp", ("data",)),
]


def mesh_shape(pod=None) -> MeshShape:
    if pod:
        return MeshShape(("pod", "data", "model"), (pod, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def jax_mesh(shape: MeshShape):
    """What ``jax_channels.ShardingRules`` reads of a mesh."""
    return types.SimpleNamespace(axis_names=shape.mesh_dim_names,
                                 devices=np.empty(shape.shape, dtype=object))


def fake(pod=None):
    return ShardingRules(mesh_shape(pod), RULES_16x16)


def jax_fake(pod=None):
    return jax_channels.ShardingRules(jax_mesh(mesh_shape(pod)), RULES_16x16)


def as_tuple(spec: P) -> tuple:
    return tuple(spec)


def test_divisible_dims_get_sharded():
    r = fake(pod=2)
    spec = r.partition_spec((256, 4096, 4096), ("batch", "seq", "d_model"))
    assert spec == as_tuple(P(("pod", "data")))
    spec = r.partition_spec((4096, 22528), ("d_model_fsdp", "d_ff"))
    assert spec == as_tuple(P(("pod", "data"), "model"))


def test_indivisible_falls_back():
    r = fake()
    # 10 heads don't divide 16 -> replicate (batch 32 shards over data)
    assert r.partition_spec((32, 1, 10, 256),
                            ("batch", "seq", "heads", "head_dim")) == ("data",)
    # batch=1 (long_500k) unshardable -> fully replicated
    assert r.partition_spec((1, 128), ("batch", "seq")) == ()


def test_exclusivity_kv_fallback_to_seq():
    """kv_heads=8 can't take the 16-way model axis -> kv_seq takes it
    (FlashDecoding split), exactly one of them."""
    r = fake()
    spec = r.partition_spec(
        (128, 8, 32768, 128), ("batch", "kv_heads", "kv_seq", "head_dim"))
    assert spec == ("data", None, "model")
    spec = r.partition_spec(
        (128, 16, 32768, 128), ("batch", "kv_heads", "kv_seq", "head_dim"))
    assert spec == ("data", "model")


def test_missing_pod_axis_degrades():
    r = fake(pod=None)
    assert r.partition_spec((256, 16), ("batch", "seq")) == ("data",)


@given(
    shape=st.lists(st.integers(1, 4096), min_size=1, max_size=5),
    names=st.lists(
        st.sampled_from(
            ["batch", "seq", "d_model", "d_ff", "heads", "kv_heads",
             "kv_seq", "vocab", "d_model_fsdp", None]
        ),
        min_size=1, max_size=5,
    ),
    pod=st.sampled_from([None, 2, 4]),
)
@settings(max_examples=200, deadline=None)
def test_derivation_total_sound_and_equal_to_jax(shape, names, pod):
    """For any shape x axis-name combination the derivation is valid (every
    sharded dim divisible, no mesh axis reused) and equals the JAX
    package's."""
    n = min(len(shape), len(names))
    shape, names = tuple(shape[:n]), tuple(names[:n])
    r = fake(pod=pod)
    spec = r.partition_spec(shape, names)
    assert spec == as_tuple(jax_fake(pod=pod).partition_spec(shape, names))
    used = []
    for dim, entry in zip(shape, spec + (None,) * (n - len(spec))):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        prod = 1
        for a in axes:
            assert a not in used, f"axis {a} reused in {spec}"
            used.append(a)
            prod *= r.axis_sizes[a]
        assert dim % prod == 0, f"dim {dim} not divisible by {prod} in {spec}"


@given(n=st.integers(1, 10**7), m=st.integers(1, 512))
@settings(max_examples=200, deadline=None)
def test_padded_size_properties(n, m):
    p = padded_size(n, m)
    assert p >= n
    assert p % m == 0
    assert p - n < m
    assert p == jax_channels.padded_size(n, m)


def test_struct_on_a_one_device_mesh_is_a_fake_tensor_of_the_channel():
    import torch
    from torch._subclasses.fake_tensor import FakeTensor

    rules = training_rules(MeshShape(("data", "model"), (1, 1)))
    ch = Channel("tokens", (8, 128), torch.int32, ("batch", "seq"))
    struct = rules.struct(ch)
    assert tuple(struct.shape) == (8, 128)
    assert struct.dtype == torch.int32
    assert isinstance(struct, FakeTensor)
    assert rules.sharding(ch) == (rules.mesh, rules.placements((8, 128),
                                                               ("batch", "seq")))


def test_preset_rules_exist():
    m = MeshShape(("data", "model"), (1, 1))
    for r in (training_rules(m), decode_rules(m), long_context_rules(m)):
        assert r.partition_spec((4, 4), ("batch", "seq")) is not None


def test_placements_shard_a_dim_on_every_mesh_axis_of_its_rule():
    from torch.distributed.tensor import Replicate, Shard

    r = fake(pod=2)
    assert r.placements((256, 4096, 22528), ("batch", "seq", "d_ff")) == (
        Shard(0), Shard(0), Shard(2))
    assert r.placements((1, 7), ("batch", "seq")) == (
        Replicate(), Replicate(), Replicate())
    assert r.local_shape((256, 4096, 22528), ("batch", "seq", "d_ff")) == (
        8, 4096, 1408)


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, ParamSpec) or hasattr(tree, "logical_axes"):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _spec_leaves(tree[k], f"{prefix}/{k}")


def _cache_leaves(spec, prefix=""):
    for kind in sorted(spec):
        for name in sorted(spec[kind]):
            shp, _dt, axes, _fill = spec[kind][name]
            yield f"{prefix}/{kind}/{name}", shp, axes


@pytest.mark.parametrize("pod", [None, 2], ids=["16x16", "2x16x16"])
def test_every_leaf_of_every_cell_at_tp16_has_the_jax_packages_spec(pod):
    cells = [(cfg, shape) for cfg, shape, runnable in all_cells() if runnable]
    jax_cells = [(c, s) for c, s, r in jax_all_cells() if r]
    assert [(c.name, s.name) for c, s in cells] == \
        [(c.name, s.name) for c, s in jax_cells]
    mesh = mesh_shape(pod)
    compared = 0
    for (cfg, shape), (jcfg, _js) in zip(cells, jax_cells):
        rules = rules_for_shape_kind(mesh, shape.kind)
        jrules = jax_channels.rules_for_shape_kind(jax_mesh(mesh), shape.kind)
        specs = dict(_spec_leaves(steps.model_param_specs(cfg, 16)))
        jspecs = dict(_spec_leaves(jax_steps.model_param_specs(jcfg, 16)))
        assert specs.keys() == jspecs.keys(), cfg.name
        for path, spec in specs.items():
            j = jspecs[path]
            assert spec.shape == tuple(j.shape), (cfg.name, path)
            assert spec.logical_axes == tuple(j.logical_axes), (cfg.name, path)
            got = rules.partition_spec(spec.shape, spec.logical_axes)
            want = as_tuple(jrules.partition_spec(j.shape, j.logical_axes))
            assert got == want, (cfg.name, shape.name, path, got, want)
            compared += 1
        if shape.kind in ("decode", "long") and not cfg.encoder_layers:
            B, S = shape.global_batch, shape.seq_len
            mine = lm.cache_spec(cfg, B, S, 16)
            theirs = jax_lm.cache_spec(jcfg, B, S, 16)
            for (path, shp, axes), (_p, jshp, jaxes) in zip(
                    _cache_leaves(mine), _cache_leaves(theirs)):
                assert (shp, axes) == (tuple(jshp), tuple(jaxes)), path
                assert rules.partition_spec(shp, axes) == as_tuple(
                    jrules.partition_spec(jshp, jaxes)), (cfg.name, path)
                compared += 1
    assert compared > 600  # 669 leaves over the 33 runnable cells
