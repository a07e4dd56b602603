"""The training executor: a fault-tolerant step loop (the JAX package's
``runtime/executor.py``), on one device or over a mesh.

    load  : init or restore state -> build the step                  (timed)
    run   : per step: data -> train_step -> metrics                  (timed)
            async checkpoint every K steps
            failure check: crash or node loss -> restore from the last
            checkpoint and replay; a straggler is detected (monitor)
    finish: final blocking checkpoint; the load/run timing report

The data pipeline is the Emit stage, and restore-and-replay is the
demand-driven re-dispatch of the paper's protocol in its SPMD form.  With
``rules`` (and their ``mesh``) the parameters, moments and batches are
DTensors placed by the rules; with an ``ElasticController``, a node loss
re-meshes onto the surviving nodes and restores the last checkpoint onto
the new placements.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager, config_hash
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.timing import TimingCollector
from repro_torch.data.pipeline import DataPipeline, source_for
from repro_torch.device import resolve_device
from repro_torch.kernels._shard import whole
from repro_torch.models.common import init_params, param_shardings
from repro_torch.optim import adamw
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.failures import (
    FailurePlan,
    SimulatedNodeFailure,
    StragglerMonitor,
)

log = logging.getLogger("repro_torch.executor")


def _writes(mesh) -> bool:
    """Whether this process writes the checkpoints: the first rank of the
    mesh (every process of a single-process run)."""
    import torch.distributed as dist

    if mesh is None or not dist.is_initialized():
        return True
    return dist.get_rank() == int(mesh.mesh.min())


@dataclass
class TrainerConfig:
    num_steps: int = 20
    checkpoint_every: int = 10
    checkpoint_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    peak_lr: float = 3e-4
    warmup_steps: int = 10
    seed: int = 0
    tp: int = 1
    resume: bool = True
    max_restarts: int = 4


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        shape: ShapeConfig,
        trainer_cfg: TrainerConfig,
        opt_cfg: adamw.AdamWConfig | None = None,
        rules=None,
        mesh=None,
        failure_plan: FailurePlan | None = None,
        elastic=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.shape = shape
        self.cfg = trainer_cfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.rules = rules
        self.mesh = mesh if mesh is not None else (
            rules.mesh if rules is not None else None)
        self.elastic = elastic
        self.excluded_nodes: set[int] = set()
        self.failure_plan = failure_plan or FailurePlan()
        self.timing = TimingCollector()
        self.monitor = StragglerMonitor()
        self.ckpt = CheckpointManager(
            trainer_cfg.checkpoint_dir, keep=trainer_cfg.keep_checkpoints
        )
        self.metrics_history: list[dict] = []
        self.restarts = 0
        self.excluded = False  # this rank left the mesh at a re-mesh
        self._build()

    # -- load phase -----------------------------------------------------------

    def _build(self) -> None:
        self.ckpt.writer = _writes(self.mesh)
        with self.timing.phase("host", "load"):
            self.train_step = steps_mod.make_train_step(
                self.model_cfg, self.opt_cfg, tp=self.cfg.tp, rules=self.rules,
                peak_lr=self.cfg.peak_lr, warmup_steps=self.cfg.warmup_steps,
                total_steps=self.cfg.num_steps,
            )
            self.pipeline = DataPipeline(
                source_for(self.model_cfg, self.shape, seed=self.cfg.seed),
                self.device, self.rules,
            )
            self.step0, self.params, self.opt_state = self._init_or_restore()

    def _state_shardings(self):
        if self.rules is None:
            return None
        specs = steps_mod.model_param_specs(self.model_cfg, self.cfg.tp)
        p_sh = param_shardings(specs, self.rules)
        return {"params": p_sh, "opt": {"m": p_sh, "v": p_sh, "count": None}}

    def _init_or_restore(self):
        meta = {"config_hash": config_hash(self.model_cfg)}
        if self.cfg.resume and self.ckpt.latest_step() is not None:
            step, state, _m = self.ckpt.restore(
                device=self.device, expect_meta=meta,
                shardings=self._state_shardings())
            log.info("restored checkpoint at step %d", step)
            return step, state["params"], state["opt"]
        specs = steps_mod.model_param_specs(self.model_cfg, self.cfg.tp)
        params = init_params(specs, self.cfg.seed, self.device,
                             getattr(torch, self.model_cfg.param_dtype),
                             rules=self.rules)
        opt_state = adamw.init_state(params, self.opt_cfg)
        return 0, params, opt_state

    def _save(self, step: int, block: bool = False) -> None:
        state = {"params": self.params, "opt": self.opt_state}
        meta = {"config_hash": config_hash(self.model_cfg)}
        if block:
            self.ckpt.save(step, state, meta)
        else:
            self.ckpt.save_async(step, state, meta)

    # -- failure handling -------------------------------------------------------

    def _handle_failure(self, exc: SimulatedNodeFailure) -> None:
        self.restarts += 1
        if self.restarts > self.cfg.max_restarts:
            raise RuntimeError("restart budget exhausted") from exc
        log.warning("handling %s (restart %d)", exc, self.restarts)
        self.ckpt.wait()
        if exc.kind in ("node_loss", "straggler") and self.elastic is not None:
            self.excluded_nodes.add(exc.node)
            nodes = self.elastic.largest_batch_divisor_nodes(
                self.shape.global_batch, self.excluded_nodes)
            self.mesh, self.rules = self.elastic.build(nodes)
            log.warning("elastic re-mesh onto nodes %s -> mesh %s", nodes,
                        dict(zip(self.mesh.mesh_dim_names, self.mesh.shape)))
            if self.mesh.get_coordinate() is None:
                self.excluded = True  # a lost node's rank: it stops here
                return
        # Crash or re-mesh: rebuild the step and restore the last checkpoint.
        self._build()

    # -- run phase ---------------------------------------------------------------

    def run(self) -> dict:
        step = self.step0
        end = self.cfg.num_steps
        while step < end:
            try:
                ev = self.failure_plan.check(step)
                if ev is not None and ev.kind in ("crash", "node_loss"):
                    raise SimulatedNodeFailure(step, ev.kind, ev.node)
                t0 = time.perf_counter()
                batch = self.pipeline.get(step)
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch, step
                )
                if ev is not None and ev.kind == "straggler":
                    time.sleep(ev.slowdown * max(self.monitor.median(), 1e-3))
                row = {k: float(whole(v)) for k, v in metrics.items()}  # waits
                dt = time.perf_counter() - t0
                self.timing.add("host", "run", dt * 1e3)
                straggling = self.monitor.record(dt)
                if straggling and self.elastic is not None and ev is not None:
                    raise SimulatedNodeFailure(step, "straggler", ev.node)
                self.metrics_history.append(row | {"step": step})
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self._save(step)
            except SimulatedNodeFailure as exc:
                self._handle_failure(exc)
                if self.excluded:
                    return {"final_step": step, "restarts": self.restarts,
                            "excluded": True, "last_metrics": {},
                            "timing": self.timing.report()}
                step = self.step0
        self.ckpt.wait()
        self._save(end, block=True)
        return {
            "final_step": end,
            "restarts": self.restarts,
            "last_metrics": self.metrics_history[-1] if self.metrics_history else {},
            "timing": self.timing.report(),
        }
