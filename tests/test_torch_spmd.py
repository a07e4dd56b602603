"""The port's SPMD analysis against the JAX package's, on the CPU.

* ``models/flops.py``: ``step_flops`` and ``param_counts`` equal the JAX
  package's for all 40 cells (exact: the same integer arithmetic).
* ``core/hlo.py``: the copied text parser gives the JAX parser's
  ``CollectiveSummary`` on the same HLO text (exact), and the trace
  recorder finds the one forward all-reduce of a column- then row-parallel
  MLP on a 2 x 4 fake mesh, B·S·D·4 bytes over the 4-way model axis.
* Padding at tp 2 and 4 (``head_plan``'s grouped plan with padded q and
  KV heads, and ``expand_kv``): the port's padded forward, its parameters
  the tp = 1 JAX ones carried by ``convert.pad_for_tp``, within 2e-4 of
  the JAX tp = 1 logits (``tests/test_archs.py``'s tolerance).
* The dry-run: every family's smoke config traced on a 2 x 4 fake mesh
  with fake tensors, prefill, decode and train: no real tensor is made,
  ``argument_bytes`` is exactly the sum of the local shards' bytes, and the
  JSON has the JAX dry-run's fields.  The fake tensors are ``cpu`` ones:
  fake ``cuda`` tensors need a CUDA build of PyTorch (some ops call its
  device guard), which this CPU build is not; ``chip_smoke.py`` traces
  with fake ``cuda`` tensors on the card's host.

One fake process group per module (xdist runs files apart): the fixture
makes it and destroys it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import all_cells as jax_all_cells
from repro.configs.registry import get_config as jax_get_config
from repro.core import hlo as jax_hlo
from repro.models import flops as jax_flops
from repro.models import lm as jax_lm
from repro.models.common import init_params as jax_init_params
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS, all_cells, get_config
from repro_torch.core import hlo
from repro_torch.core.channels import fake_mode, rules_for_shape_kind
from repro_torch.launch.dryrun import analyze_cell
from repro_torch.launch.mesh import init_fake_process_group, make_mesh
from repro_torch.models import flops, lm
from repro_torch.models.convert import pad_for_tp, params_from_numpy
from repro_torch.runtime import steps

LOGIT_TOL = 2e-4


@pytest.fixture(scope="module")
def fake_group():
    init_fake_process_group(8)
    yield
    dist.destroy_process_group()


# -- analytic and parsed figures ----------------------------------------------


def test_step_flops_and_param_counts_equal_the_jax_packages_for_every_cell():
    cells = all_cells()
    jcells = jax_all_cells()
    assert len(cells) == len(jcells) == 40
    for (cfg, shape, _r), (jcfg, jshape, _jr) in zip(cells, jcells):
        assert (cfg.name, shape.name) == (jcfg.name, jshape.name)
        assert flops.param_counts(cfg) == jax_flops.param_counts(jcfg)
        for tp in (1, 16):
            mine = flops.step_flops(cfg, shape, tp=tp)
            theirs = jax_flops.step_flops(jcfg, jshape, tp=tp)
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), \
                (cfg.name, shape.name, tp)


HLO_TEXT = """
HloModule step
  %all-reduce.2 = f32[2,128,512]{2,1,0} all-reduce(%x), channel_id=1, replica_groups=[4,16]<=[64], to_apply=%add
  %all-gather-start.3 = (bf16[8,256]{1,0}, bf16[128,256]{1,0}) all-gather-start(%p), channel_id=2, replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %all-gather-done.3 = bf16[128,256]{1,0} all-gather-done(%all-gather-start.3)
  %reduce-scatter.4 = f32[64,32]{1,0} reduce-scatter(%g), channel_id=3, replica_groups=[16,16]<=[256], dimensions={0}
  %all-to-all.5 = bf16[4,16,64]{2,1,0} all-to-all(%t), channel_id=4, replica_groups=[2,8]<=[16]
  %collective-permute.6 = s32[10]{0} collective-permute(%c), source_target_pairs={{0,1},{1,0}}
  %fusion.7 = f32[2,128]{1,0} fusion(%a, %b), kind=kLoop
"""


def test_the_copied_parser_gives_the_jax_parsers_summary():
    mine = hlo.parse_collectives(HLO_TEXT)
    theirs = jax_hlo.parse_collectives(HLO_TEXT)
    assert len(mine.ops) == len(theirs.ops) == 5
    for a, b in zip(mine.ops, theirs.ops):
        assert (a.kind, a.result_bytes, a.group_size, a.line) == \
            (b.kind, b.result_bytes, b.group_size, b.line)
        assert a.link_bytes == b.link_bytes
    assert mine.by_kind() == theirs.by_kind()
    assert mine.schedule() == theirs.schedule()
    assert mine.describe() == theirs.describe()
    assert hlo.count_op(HLO_TEXT, "fusion") == jax_hlo.count_op(HLO_TEXT, "fusion")


def test_recorder_finds_the_one_forward_all_reduce_of_a_tp_mlp(fake_group):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    B, S, D, F = 2, 16, 32, 64
    with fake_mode():
        def dt(shape, placements):
            local = list(shape)
            for p, n in zip(placements, mesh.shape):
                if p.is_shard():
                    local[p.dim] //= n
            return DTensor.from_local(torch.empty(local), mesh, placements,
                                      run_check=False, shape=torch.Size(shape),
                                      stride=torch.empty(shape).stride())

        x = dt((B, S, D), (Replicate(), Replicate()))
        w1 = dt((D, F), (Replicate(), Shard(1)))  # column parallel
        w2 = dt((F, D), (Replicate(), Shard(0)))  # row parallel
        with hlo.TraceRecorder() as rec:
            y = (x @ w1) @ w2
            y = y.redistribute(mesh, (Replicate(), Replicate()))
    ops = rec.collectives.ops
    assert [(op.kind, op.result_bytes, op.group_size) for op in ops] == [
        ("all-reduce", B * S * D * 4, 4)]
    parsed = hlo.parse_collectives(rec.hlo_text())
    assert [(op.kind, op.result_bytes, op.group_size) for op in parsed.ops] == [
        ("all-reduce", B * S * D * 4, 4)]
    assert rec.flops == 2 * (2 * B * S * D * (F // 4))


# -- padding ----------------------------------------------------------------------

# (name, config overrides, tp, the plan the port must take)
PADDED = [
    ("grouped-2", dict(num_heads=6, num_kv_heads=2, vocab_size=250), 2,
     {"Hp": 6, "Kp": 2, "mode": "grouped"}),
    ("expand_kv-4", dict(num_heads=6, num_kv_heads=2, vocab_size=250), 4,
     {"Hp": 8, "Kp": 2, "mode": "expand_kv"}),
    ("kv-padded-4", dict(num_heads=10, num_kv_heads=5, vocab_size=250), 4,
     {"Hp": 12, "Kp": 6, "mode": "grouped"}),
]


@pytest.mark.parametrize("name,over,tp,plan", PADDED, ids=[p[0] for p in PADDED])
def test_tp_padding_preserves_outputs(name, over, tp, plan):
    jcfg = dataclasses.replace(jax_get_config("phi3-medium-14b").smoke(),
                               compute_dtype="float32", **over)
    cfg = dataclasses.replace(get_config("phi3-medium-14b").smoke(),
                              compute_dtype="float32", **over)
    assert lm.head_plan(cfg, tp) == plan == jax_lm.head_plan(jcfg, tp)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_lm.lm_param_specs(jcfg, 1), jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(0)
    tree["final_norm"] = (0.2 * rng.standard_normal(
        tree["final_norm"].shape)).astype(np.float32)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    jp = jax.tree.map(jnp.asarray, tree)
    x1, _ = jax_lm.forward_hidden(jcfg, jp, jnp.asarray(toks), tp=1)
    want = np.asarray(jax_lm.logits_from_hidden(jcfg, jp, x1))

    padded = pad_for_tp(cfg, params_from_numpy(tree, "cpu"), tp)
    specs = lm.lm_param_specs(cfg, tp)
    assert padded["blocks"]["attn"]["wq"].shape == specs["blocks"]["attn"]["wq"].shape
    assert padded["embed"].shape[0] == cfg.padded_vocab(tp)
    with torch.no_grad():
        x, _ = lm.forward_hidden(cfg, padded, torch.from_numpy(toks), tp=tp)
        got = lm.logits_from_hidden(cfg, padded, x)[..., : cfg.vocab_size]
        # decode against the prefilled cache takes the same plan
        logits, cache = lm.prefill(cfg, padded, torch.from_numpy(toks[:, :8]),
                                   16, tp=tp)
        step, _ = lm.decode_step(cfg, padded, cache,
                                 torch.from_numpy(toks[:, 8:9]), 8, tp=tp)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL)
    np.testing.assert_allclose(step[:, 0, : cfg.vocab_size].numpy(),
                               want[:, 8], atol=LOGIT_TOL)


# -- the dry-run -----------------------------------------------------------------

JAX_DRYRUN_FIELDS = {
    "arch", "shape", "mesh", "chips", "kind", "ok", "load_compile_s",
    "memory", "cost_analysis", "collectives", "model_flops_global",
    "params_total", "params_active",
}
JAX_MEMORY_FIELDS = {
    "argument_bytes_per_device", "temp_bytes_per_device",
    "output_bytes_per_device", "alias_bytes_per_device",
    "live_bytes_per_device", "fits_hbm", "hbm_fraction",
}
FAMILIES = ["yi-9b", "recurrentgemma-2b", "gemma3-4b", "olmoe-1b-7b",
            "llama4-maverick-400b-a17b", "xlstm-350m", "internvl2-2b",
            "seamless-m4t-large-v2"]


def _expected_argument_bytes(cfg, shape, rules, tp):
    """The local shards' bytes of every input, from the specs and rules."""
    from repro_torch.data.pipeline import BATCH_AXES
    from repro_torch.models.common import _iter_leaves

    def local_bytes(shp, axes, dtype):
        n = 1
        for d in rules.local_shape(shp, axes):
            n *= d
        return n * torch.empty((), dtype=dtype).element_size()

    pdt = getattr(torch, cfg.param_dtype)
    params = sum(local_bytes(s.shape, s.logical_axes, pdt)
                 for _p, s in _iter_leaves(steps.model_param_specs(cfg, tp)))
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        if cfg.encoder_layers:
            cache = 4 * local_bytes((cfg.num_layers, B, S, lm.head_plan(cfg, tp)["Kp"],
                                     cfg.head_dim),
                                    ("layers", "batch", "kv_seq", "kv_heads",
                                     "head_dim"), torch.float32)
        else:
            cache = sum(local_bytes(shp, axes, dt)
                        for leaves in lm.cache_spec(cfg, B, S, tp,
                                                    torch.float32).values()
                        for shp, dt, axes, _f in leaves.values())
        return params + cache + local_bytes((B, 1), ("batch", "seq"), torch.long)
    batch = local_bytes((B, S), BATCH_AXES["tokens"], torch.long)
    if cfg.encoder_layers:
        batch += local_bytes((B, S, cfg.d_model), BATCH_AXES["frames"],
                             torch.bfloat16)
    elif cfg.frontend:
        batch += local_bytes((B, cfg.frontend_len, cfg.d_model),
                             BATCH_AXES["extra_embeds"], torch.bfloat16)
    if shape.kind == "prefill":
        return params + batch
    targets = local_bytes((B, S), BATCH_AXES["targets"], torch.long)
    return 3 * params + 4 + batch + targets  # params, m, v (f32) and count


@pytest.mark.parametrize("arch", FAMILIES)
def test_dry_run_of_every_family_on_a_fake_2x4_mesh(fake_group, arch):
    cfg = dataclasses.replace(ARCHS[arch].smoke(), compute_dtype="float32")
    made_real, real_inputs = [], []
    orig = hlo.TraceRecorder._track
    orig_exit = hlo.TraceRecorder.__exit__

    def exit_(self, *exc):  # no op of the trace was handed a real tensor
        real_inputs.extend(self.real_inputs)
        return orig_exit(self, *exc)

    def track(self, t):  # every op's output must be fake
        if not isinstance(t, torch._subclasses.fake_tensor.FakeTensor):
            made_real.append(t)
        return orig(self, t)

    hlo.TraceRecorder._track = track
    hlo.TraceRecorder.__exit__ = exit_
    try:
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        for kind in ("prefill", "decode", "train"):
            shape = ShapeConfig(kind, 32, 4, kind)
            r = analyze_cell(cfg, shape, mesh, "2x4")
            assert set(r) == JAX_DRYRUN_FIELDS
            assert set(r["memory"]) == JAX_MEMORY_FIELDS
            assert r["ok"] and r["chips"] == 8
            rules = rules_for_shape_kind(mesh, kind)
            assert r["memory"]["argument_bytes_per_device"] == \
                _expected_argument_bytes(cfg, shape, rules, 4), kind
            assert r["cost_analysis"]["flops_per_device"] > 0
            assert r["collectives"]["total_ops"] > 0
    finally:
        hlo.TraceRecorder._track = orig
        hlo.TraceRecorder.__exit__ = orig_exit
    assert made_real == [] and real_inputs == []
