"""The port's expert-parallel MoE under sharding rules, on the CPU.

* 8 gloo ranks on a 2 data x 4 model mesh: the olmoe-1b-7b smoke config in
  float32 (4 experts, one a rank) with its capacity factor cut to 1.0 so
  that slots are dropped, under ``remat_policy="dots"``.  Each rank runs
  its expert's slice only (``_shard.run_split``); its routing equals the
  unsharded port's on its rows, exactly; each rank's expert-weight
  gradients, summed over ``data``, equal its slice of the unsharded port's
  within 1e-6; one train step's loss and grad norm are within 1e-4 of the
  JAX package's unsharded step, and its drop fraction equals JAX's.
* Serving under the rules: the prefill step outside autograd on the same
  ranks (yi-9b under the decode rules, olmoe-1b-7b under the prefill
  rules), its logits within 2e-4 of the unsharded port's.
* The dry-run's fake trace of the same config's train step on a fake
  2 x 4 mesh: no expert weight is gathered over ``model``, and each MoE
  layer's slots are summed over ``model`` (one all-reduce of
  [B / data, S * k, D] per forward, the recompute's included).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import source_for as jax_source_for
from repro.models.common import init_params as jax_init_params
from repro.optim import adamw as jax_adamw
from repro.runtime import steps as jax_steps
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.builder import ClusterBuilder
from repro_torch.data.pipeline import source_for
from repro_torch.launch.dryrun import build_cell
from repro_torch.launch.mesh import init_fake_process_group, make_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from test_torch_distributed import run_ranks

OLMOE = "olmoe-1b-7b"
OVERRIDES = dict(compute_dtype="float32", capacity_factor=1.0, remat_policy="dots")
LOSS_TOL = 1e-4  # tests/test_distributed.py's
GRAD_TOL = 1e-6
B, S = 8, 32


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_expert_parallel_step_on_2x4_gloo_ranks(tmp_path):
    jcfg = dataclasses.replace(jax_get_config(OLMOE).smoke(), **OVERRIDES)
    jshape = JaxShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    jparams = jax_init_params(jax_steps.model_param_specs(jcfg, 1),
                              jax.random.PRNGKey(0), jnp.float32)
    opt_cfg = jax_adamw.AdamWConfig()
    jstep = jax.jit(jax_steps.make_train_step(jcfg, opt_cfg, tp=1, rules=None))
    jbatch = jax_source_for(jcfg, jshape).batch(0)
    _p, _o, jm = jstep(jparams, jax_adamw.init_state(jparams, opt_cfg),
                       {k: jnp.asarray(v) for k, v in jbatch.items()}, jnp.int32(0))
    flat = _flat(jparams)
    np.savez(tmp_path / "params.npz", **flat)

    # The unsharded port on the same parameters and batch: routing of every
    # MoE layer and the expert weights' gradients.
    cfg = dataclasses.replace(get_config(OLMOE).smoke(), **OVERRIDES)
    shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in source_for(cfg, shape).batch(0).items()}
    routes = []
    orig = moe_mod.top_k_lowest_index_first

    def record(probs, k):
        values, indices = orig(probs, k)
        routes.append(indices.clone())
        return values, indices

    leaves = adamw.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    moe_mod.top_k_lowest_index_first = record
    try:
        loss, _m = steps.loss_fn_for(cfg)(params, batch)
        routes = routes[:cfg.num_layers]  # the recompute routes again
        names = ("w_gate", "w_up", "w_down")
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params["blocks"]["moe"]["moe"][n] for n in names])))
    finally:
        moe_mod.top_k_lowest_index_first = orig
    np.savez(tmp_path / "plain.npz", **{f"route{i}": r.numpy() for i, r in enumerate(routes)},
             **{f"grad_{n}": g.numpy() for n, g in grads.items()})

    got = run_ranks(f"""
        import dataclasses
        import numpy as np
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.configs.registry import get_config
        from repro_torch.core.channels import training_rules
        from repro_torch.data.pipeline import shard_batch, source_for
        from repro_torch.models import moe
        from repro_torch.models.common import ParamSpec
        from repro_torch.models.convert import params_from_numpy
        from repro_torch.optim import adamw
        from repro_torch.runtime import steps

        cfg = dataclasses.replace(get_config("{OLMOE}").smoke(), **{OVERRIDES!r})
        shape = ShapeConfig("t", seq_len={S}, global_batch={B}, kind="train")
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        rules = training_rules(mesh)
        tp = 4
        tree = {{}}
        with np.load({str(tmp_path / "params.npz")!r}) as z:
            for path in z.files:
                node = tree
                *head, leaf = path.split("/")
                for k in head:
                    node = node.setdefault(k, {{}})
                node[leaf] = z[path]
        plain = dict(np.load({str(tmp_path / "plain.npz")!r}))

        def place(spec, leaf):
            if isinstance(spec, ParamSpec):
                return rules.distribute(leaf, spec.logical_axes)
            return {{k: place(spec[k], leaf[k]) for k in spec}}

        params = place(steps.model_param_specs(cfg, tp),
                       params_from_numpy(tree, "cpu"))
        batch = shard_batch(source_for(cfg, shape).batch(0), rules, "cpu")
        data, model = mesh.get_coordinate()
        rows = slice(data * {B // 2}, (data + 1) * {B // 2})

        routes, experts_seen = [], []
        orig_top_k, orig_core = moe.top_k_lowest_index_first, moe._moe_core

        def record(probs, k):
            values, indices = orig_top_k(probs, k)
            routes.append(indices)
            return values, indices

        def core(x, params, **kw):
            experts_seen.append((params["w_gate"].shape[0], kw["part"].offset))
            return orig_core(x, params, **kw)

        moe.top_k_lowest_index_first, moe._moe_core = record, core
        leaves = adamw.tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        with steps.lm_mod.spmd(rules):
            loss, _m = steps.loss_fn_for(cfg, tp, rules)(params, batch)
            forward_routes = list(routes)  # the recompute routes again
            names = ("w_gate", "w_up", "w_down")
            grads = torch.autograd.grad(
                loss, [params["blocks"]["moe"]["moe"][n] for n in names])
        for leaf in leaves:
            leaf.requires_grad_(False)
        moe.top_k_lowest_index_first = orig_top_k
        routing_equal = len(forward_routes) == cfg.num_layers and all(
            np.array_equal(r.numpy(), plain[f"route{{i}}"][rows])
            for i, r in enumerate(forward_routes))
        grad_err = 0.0
        for n, g in zip(names, grads):
            g = g.redistribute(mesh, (Replicate(), Shard(1))).to_local()
            want = plain["grad_" + n][:, model:model + 1]
            grad_err = max(grad_err, float(np.abs(g.numpy() - want).max()))

        opt_cfg = adamw.AdamWConfig()
        step = steps.make_train_step(cfg, opt_cfg, tp=tp, rules=rules)
        _p, _o, m = step(params, adamw.init_state(params, opt_cfg), batch, 0)
        flags = torch.tensor([float(not routing_equal), grad_err])
        dist.all_reduce(flags, op=dist.ReduceOp.MAX)
        print(json.dumps({{"loss": float(m["loss"].full_tensor()),
                          "grad_norm": float(m["grad_norm"].full_tensor()),
                          "drop": float(m["moe_drop_fraction"].full_tensor()),
                          "routing_differs_somewhere": bool(flags[0]),
                          "max_expert_grad_err": float(flags[1]),
                          "experts_seen": experts_seen,
                          "layers": cfg.num_layers}}))
    """, world=8, tmp_path=tmp_path, timeout=300)
    print("sharded - jax: loss", got["loss"] - float(jm["loss"]),
          "grad_norm", got["grad_norm"] - float(jm["grad_norm"]),
          "expert grads", got["max_expert_grad_err"])
    # rank 0 (data 0, model 0) ran expert 0 alone, in every layer, in the
    # routing pass, the forward and the recompute of the gradient pass
    assert got["experts_seen"] and set(map(tuple, got["experts_seen"])) == {(1, 0)}
    assert not got["routing_differs_somewhere"]
    assert 0.0 < float(jm["moe_drop_fraction"]) == got["drop"]
    assert got["max_expert_grad_err"] <= GRAD_TOL
    assert abs(got["loss"] - float(jm["loss"])) < LOSS_TOL
    assert abs(got["grad_norm"] - float(jm["grad_norm"])) < LOSS_TOL


def test_sharded_prefill_without_a_gradient_on_2x4_gloo_ranks(tmp_path):
    """The prefill step under the rules, outside autograd (serving): the
    embedding's vocab-parallel lookup once raised on a table sharded over
    d_model as well (a token shard's mask met the gathered rows).  Logits
    of yi-9b (decode rules) and olmoe-1b-7b (expert-parallel, prefill
    rules) within 2e-4 of the unsharded port's."""
    cases = [("yi-9b", "decode"), (OLMOE, "prefill")]
    want = {}
    for arch, _kind in cases:
        cfg = dataclasses.replace(get_config(arch).smoke(), compute_dtype="float32")
        shape = ShapeConfig("t", seq_len=S, global_batch=B, kind="prefill")
        params = init_params(steps.model_param_specs(cfg, 4), 0, "cpu")
        tokens = torch.from_numpy(source_for(cfg, shape).batch(0)["tokens"])
        with torch.no_grad():
            want[arch] = steps.make_prefill_step(cfg, tp=4)(params, {"tokens": tokens})
    got = run_ranks(f"""
        import dataclasses
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.configs.registry import get_config
        from repro_torch.core.channels import rules_for_shape_kind
        from repro_torch.data.pipeline import shard_batch, source_for
        from repro_torch.models.common import init_params
        from repro_torch.runtime import steps

        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        out = {{}}
        for arch, kind in {cases!r}:
            cfg = dataclasses.replace(get_config(arch).smoke(), compute_dtype="float32")
            shape = ShapeConfig("t", seq_len={S}, global_batch={B}, kind="prefill")
            rules = rules_for_shape_kind(mesh, kind)
            params = init_params(steps.model_param_specs(cfg, 4), 0, "cpu", rules=rules)
            tokens = shard_batch(source_for(cfg, shape).batch(0), rules, "cpu")["tokens"]
            with torch.no_grad():
                logits = steps.make_prefill_step(cfg, tp=4, rules=rules)(
                    params, {{"tokens": tokens}})
            out[arch] = logits.full_tensor().tolist()
        print(json.dumps(out))
    """, world=8, tmp_path=tmp_path, timeout=300)
    for arch, _kind in cases:
        err = float((torch.tensor(got[arch]) - want[arch]).abs().max())
        print(arch, "sharded - plain logits", err)
        assert err <= 2e-4, arch


# -- the fake trace ---------------------------------------------------------------


def _forget_meshes():
    """Drop DTensor's cached sharding decisions: they hold the mesh they
    were made on, and a mesh equals any other of its shape whatever its
    process group, so another module's group, destroyed, would be used."""
    from torch.distributed.tensor import DTensor

    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    torch._C._clear_DTensor_sharding_propagator_cache()


@pytest.fixture(scope="module")
def fake_group():
    _forget_meshes()
    init_fake_process_group(8)
    yield
    dist.destroy_process_group()
    _forget_meshes()


def _result_shape(line: str) -> tuple[int, ...]:
    dims = re.match(r"%\S+ = \w+\[([\d,]*)\]", line).group(1)
    return tuple(int(d) for d in dims.split(",") if d)


def test_fake_trace_gathers_no_expert_weight_over_model(fake_group):
    cfg = dataclasses.replace(get_config(OLMOE).smoke(), **OVERRIDES)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    shape = ShapeConfig("train", S, 4, "train")
    fn, args, rules, _tp = build_cell(cfg, shape, mesh)
    art = ClusterBuilder(mesh=mesh, rules=rules).build_step(fn, args, name="ep")
    ops = art.collectives().ops
    E, D, F, k = cfg.num_experts, cfg.d_model, cfg.moe_d_ff, cfg.experts_per_token
    # an expert weight with its expert dim whole, whatever of D is gathered
    whole = {(E, d, F) for d in (D, D // 2)} | {(E, F, d) for d in (D, D // 2)}
    over_model = [(op.kind, _result_shape(op.line)) for op in ops if op.group_size == 4]
    assert not [s for kind, s in over_model if kind == "all-gather" and s in whole]
    slot_sums = [s for kind, s in over_model
                 if kind == "all-reduce" and s == (shape.global_batch // 2, S * k, D)]
    assert len(slot_sums) == 2 * cfg.num_layers  # forward and recompute
