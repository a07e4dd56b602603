"""The port's sharded paths on real process groups: gloo over 8 (or 4) CPU
ranks, each a subprocess, the counterparts of ``tests/test_distributed.py``.

* The sharded yi-9b smoke train step on a 2 data x 4 model mesh: loss and
  grad norm against the JAX package's unsharded step from the same
  parameters and batch, within 1e-4 (the reference test's tolerance).
* An elastic re-mesh: 4 nodes of 2 ranks train, node 3 is lost at step 5,
  the survivors re-mesh onto the largest node count that divides the
  batch (2) and resume from the last checkpoint to step 10, one restart.
* A ``serialize`` round trip of a traced step (``torch.export``), loaded
  and run on a 2 x 2 mesh.

The ranks meet through a ``FileStore`` under ``tmp_path`` (no fixed TCP
port); each test has its own timeout.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import source_for as jax_source_for
from repro.models.common import init_params as jax_init_params
from repro.optim import adamw as jax_adamw
from repro.runtime import steps as jax_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-4

_PRELUDE = """
import json, os, sys
import torch
import torch.distributed as dist
rank, world, store_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
torch.manual_seed(0)
"""


def run_ranks(code: str, world: int, tmp_path, timeout: float) -> dict:
    """Run ``code`` on ``world`` gloo ranks; rank 0's last stdout line, as
    JSON.  Every rank must exit 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    script = _PRELUDE + textwrap.dedent(code)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), store],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-4000:]}"
    return json.loads(outs[0][0].strip().splitlines()[-1])


def _cfg():
    return dataclasses.replace(jax_get_config("yi-9b").smoke(), d_model=64,
                               num_heads=4, num_kv_heads=4, vocab_size=256,
                               compute_dtype="float32")


def test_sharded_train_step_matches_the_jax_unsharded_loss(tmp_path):
    jcfg = _cfg()
    shape = JaxShapeConfig("t", seq_len=32, global_batch=8, kind="train")
    params = jax_init_params(jax_steps.model_param_specs(jcfg, 1),
                             jax.random.PRNGKey(0), jnp.float32)
    opt_cfg = jax_adamw.AdamWConfig()
    step = jax.jit(jax_steps.make_train_step(jcfg, opt_cfg, tp=1, rules=None))
    batch = jax_source_for(jcfg, shape).batch(0)
    _p, _o, m = step(params, jax_adamw.init_state(params, opt_cfg),
                     {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / "params.npz", **flat)

    got = run_ranks(f"""
        import dataclasses
        import numpy as np
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.configs.registry import get_config
        from repro_torch.core.channels import training_rules
        from repro_torch.data.pipeline import shard_batch, source_for
        from repro_torch.models.common import ParamSpec
        from repro_torch.models.convert import params_from_numpy
        from repro_torch.optim import adamw
        from repro_torch.runtime import steps

        cfg = dataclasses.replace(get_config("yi-9b").smoke(), d_model=64,
                                  num_heads=4, num_kv_heads=4, vocab_size=256,
                                  compute_dtype="float32")
        shape = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
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
        full = params_from_numpy(tree, "cpu")

        def place(spec, leaf):
            if isinstance(spec, ParamSpec):
                assert tuple(leaf.shape) == spec.shape
                return rules.distribute(leaf, spec.logical_axes)
            return {{k: place(spec[k], leaf[k]) for k in spec}}

        params = place(steps.model_param_specs(cfg, tp), full)
        opt_cfg = adamw.AdamWConfig()
        opt = adamw.init_state(params, opt_cfg)
        batch = shard_batch(source_for(cfg, shape).batch(0), rules, "cpu")
        step = steps.make_train_step(cfg, opt_cfg, tp=tp, rules=rules)
        p, o, m = step(params, opt, batch, 0)
        loss = float(m["loss"].full_tensor())
        gnorm = float(m["grad_norm"].full_tensor())
        local = params["embed"].to_local().shape
        print(json.dumps({{"loss": loss, "grad_norm": gnorm,
                          "embed_local": list(local)}}))
    """, world=8, tmp_path=tmp_path, timeout=300)
    print("sharded - jax: loss", got["loss"] - float(m["loss"]),
          "grad_norm", got["grad_norm"] - float(m["grad_norm"]))
    assert got["embed_local"] == [256 // 4, 64 // 2]  # vocab x model, d x data
    assert abs(got["loss"] - float(m["loss"])) < LOSS_TOL
    assert abs(got["grad_norm"] - float(m["grad_norm"])) < LOSS_TOL


def test_elastic_remesh_resumes_to_step_10_with_one_restart(tmp_path):
    got = run_ranks(f"""
        import dataclasses
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.configs.registry import get_config
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.runtime.elastic import ElasticController
        from repro_torch.runtime.executor import Trainer, TrainerConfig
        from repro_torch.runtime.failures import FailureEvent, FailurePlan

        cfg = dataclasses.replace(get_config("yi-9b").smoke(),
                                  compute_dtype="float32")
        shape = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
        elastic = ElasticController(model_axis=2, devices_per_node=1,
                                    shape_kind="train", device_type="cpu")
        mesh, rules = elastic.build(elastic.available_nodes())
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {{"data": 4, "model": 2}}
        tr = Trainer(cfg, shape,
                     TrainerConfig(num_steps=10, checkpoint_every=2,
                                   checkpoint_dir={str(tmp_path / "ckpt")!r},
                                   warmup_steps=1, tp=2),
                     opt_cfg=AdamWConfig(), rules=rules, mesh=mesh,
                     failure_plan=FailurePlan([
                         FailureEvent(step=5, kind="node_loss", node=3)]),
                     elastic=elastic, device="cpu")
        out = tr.run()
        print(json.dumps({{"restarts": out["restarts"],
                          "final_step": out["final_step"],
                          "excluded": out.get("excluded", False),
                          "loss": out["last_metrics"].get("loss"),
                          "mesh": dict(zip(tr.mesh.mesh_dim_names,
                                           tr.mesh.shape))}}))
    """, world=8, tmp_path=tmp_path, timeout=420)
    assert got["restarts"] == 1
    assert got["final_step"] == 10
    assert not got["excluded"]
    # node 3 lost -> 3 nodes, batch 8 % 3 != 0 -> 2 nodes of 2 ranks
    assert got["mesh"] == {"data": 2, "model": 2}
    assert np.isfinite(got["loss"])


def test_serialized_step_round_trips_on_a_2x2_mesh(tmp_path):
    got = run_ranks("""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.core.builder import ClusterBuilder

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.arange(16.0).reshape(4, 4), mesh,
                              [Shard(0), Replicate()])
        builder = ClusterBuilder(mesh=mesh)
        art = builder.build_step(lambda a: (a * 2).sum(), [x], name="double")
        payload = art.serialize()
        assert isinstance(payload, bytes) and len(payload) > 100
        loaded = ClusterBuilder.load_serialized_step(payload)
        result = loaded(x)
        print(json.dumps({"result": float(result.full_tensor()),
                          "eager": float(art(x).full_tensor()),
                          "flops": art.cost()["flops_per_device"]}))
    """, world=4, tmp_path=tmp_path, timeout=300)
    assert got["result"] == got["eager"] == float(np.arange(16.0).sum() * 2)
