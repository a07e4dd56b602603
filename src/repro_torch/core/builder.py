"""ClusterBuilder — compiles a specification into a deployed application.

This is the paper's central artifact: the builder consumes a
:class:`~repro_torch.core.dsl.ClusterSpec` or
:class:`~repro_torch.core.dsl.PipelineSpec` and produces everything else
with no user intervention:

* the **deployment plan** — the Host-Node-Loader / Node-Loader bootstrap
  of paper §4 and Figure 1 (load network on port 2000/channel 1, application
  network on a separate port, input-end-before-output-end ordering, sync
  barriers, timing return);
* the **wired process network** — for emit/cluster/collect applications, a
  runnable network (``runtime.local``) whose topology is exactly Figure 2 and
  whose protocol is the one model-checked by ``core.verify``, on the
  ``"threads"``, ``"cluster"`` or ``"service"`` backend;
* the **SPMD step** — for cluster stages that are PyTorch step functions
  over DTensors placed by ``core.channels``: ``build_step`` traces the step
  once on the builder's mesh with fake tensors (no allocation, no launch)
  and returns a :class:`StepArtifact` whose cost, memory, program text and
  collectives come from that trace, and which runs the step eagerly on
  real tensors; ``serialize`` exports it (``torch.export``) so one host
  traces and every node loads it (the analogue of JCSP code-loading
  channels, paper §4.1).

Load time (the trace) and run time are accounted separately (requirement 7).
"""

from __future__ import annotations

import io
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from repro_torch.core import hlo as hlo_mod
from repro_torch.core.timing import TimingCollector


LOAD_PORT = 2000  # paper §6: the load network uses port 2000 ...
LOAD_CHANNEL = 1  # ... and channel number 1 on every node.
APP_PORT = 3000  # application network runs on a different port (§6.1).


# ---------------------------------------------------------------------------
# Deployment plan (HNL / NL analogue).
# ---------------------------------------------------------------------------


def _fake_mode_of(args):
    """The ``FakeTensorMode`` of the first fake tensor among ``args``."""
    for t in _leaves(args):
        local = _local(t)
        mode = getattr(local, "fake_mode", None)
        if mode is not None:
            return mode
    return None


def _to_fake(mode, tree):
    """``tree`` with every real tensor (or DTensor's local shard) replaced
    by a fake one of ``mode``; fake ones pass as they are."""
    import torch

    if isinstance(tree, dict):
        return {k: _to_fake(mode, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_fake(mode, v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    if hasattr(tree, "to_local"):
        from torch.distributed.tensor import DTensor

        local = tree.to_local()
        if getattr(local, "fake_mode", None) is mode:
            return tree
        return DTensor.from_local(mode.from_tensor(local), tree.device_mesh,
                                  tree.placements, run_check=False,
                                  shape=tree.shape, stride=tree.stride())
    if getattr(tree, "fake_mode", None) is mode:
        return tree
    return mode.from_tensor(tree)


@dataclass
class NodePlan:
    node_id: str
    address: str  # ip:port/channel — the only address a node needs
    workers: int
    stage: str = ""  # pipeline stage this node serves ("" pre-pipeline)


@dataclass
class StagePlan:
    """One pipeline stage's slice of the deployment."""

    name: str
    workers: int
    nodes: list[NodePlan] = field(default_factory=list)


@dataclass
class DeploymentPlan:
    """The generated loading/bootstrap schedule of paper §4 / Figure 1."""

    host: str
    nodes: list[NodePlan]
    stages: list[StagePlan] = field(default_factory=list)
    load_port: int = LOAD_PORT
    load_channel: int = LOAD_CHANNEL
    app_port: int = APP_PORT

    @property
    def host_load_address(self) -> str:
        return f"{self.host}:{self.load_port}/{self.load_channel}"

    def load_order(self) -> list[str]:
        """The bootstrap sequence the paper prescribes (§4)."""
        steps = [
            f"HNL: create many-to-one input channel {self.host_load_address}",
            "USER: start one NodeLoader executable per node (identical binary)",
        ]
        for np_ in self.nodes:
            steps.append(
                f"NL[{np_.node_id}]: create input {np_.address}; "
                f"send own IP to {self.host_load_address}"
            )
        steps += [
            f"HNL: received {len(self.nodes)} node IPs; create output channels",
            "HNL: send node-specific NodeProcess to every node "
            "(code-loading channel; single source of class files)",
            "HNL: create HostProcess (Emit + Collect) on the host node",
        ]
        if len(self.stages) > 1:
            chain = " -> ".join(
                f"{sp.name}[{len(sp.nodes)}]" for sp in self.stages
            )
            steps.append(
                f"HNL: route stage results host-side: emit -> {chain} "
                "-> collect (per-stage credit accounting)"
            )
        steps += [
            "ALL: application net channels — input ends created before output "
            "ends; synchronisation messages on the loading network enforce "
            "the order",
            "HP: final barrier; application execution commences",
            "ALL: on termination, nodes return (load_ms, run_ms) to host; "
            "host combines with its own and reports; all resources reclaimed",
        ]
        return steps

    def describe(self) -> str:
        lines = [
            f"DeploymentPlan host={self.host} nodes={len(self.nodes)} "
            f"(load port {self.load_port}, app port {self.app_port})"
        ]
        for np_ in self.nodes:
            stage = f"  stage={np_.stage}" if np_.stage else ""
            lines.append(
                f"  node {np_.node_id}: {np_.address}  "
                f"workers={np_.workers}{stage}"
            )
        lines.append("load order:")
        for i, s in enumerate(self.load_order()):
            lines.append(f"  {i + 1}. {s}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Traced SPMD step.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MemoryAnalysis:
    """Per-device bytes, the four fields of XLA's ``memory_analysis()``:
    the inputs, the peak of the step's own live storage less its outputs
    (temp), its outputs, and the outputs that are inputs updated in place
    (alias)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int


def _leaves(tree) -> list:
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _local(t):
    """A tensor's per-device part: a DTensor's local shard."""
    return t.to_local() if hasattr(t, "to_local") else t


def _unique(tensors) -> list:
    """Each tensor (a DTensor counts as one) once, by identity."""
    seen: dict[int, Any] = {}
    for t in tensors:
        seen.setdefault(id(t), t)
    return list(seen.values())


def _bytes(t) -> int:
    """A tensor's per-device bytes: a DTensor's local shard's."""
    local = _local(t)
    return local.numel() * local.element_size()


@dataclass
class StepArtifact:
    """A traced SPMD step with analysis accessors; calling it runs ``fn``
    eagerly."""

    name: str
    fn: Callable
    mesh: Any
    load_ms: float
    recorder: hlo_mod.TraceRecorder
    memory_analysis: MemoryAnalysis
    example_args: tuple = ()

    def __call__(self, *args, **kw):
        return self.fn(*args, **kw)

    # -- analysis -----------------------------------------------------------

    def cost(self) -> dict[str, float]:
        """Per-device FLOPs (``torch.utils.flop_counter``'s formulas on
        every local op) and bytes accessed (each op's inputs read and
        outputs written).  Eager tracing runs every layer and loop step,
        so these are totals (XLA counts a ``while`` body once)."""
        return {
            "flops_per_device": float(self.recorder.flops),
            "bytes_per_device": float(self.recorder.bytes_accessed),
        }

    def memory(self) -> MemoryAnalysis:
        return self.memory_analysis

    def hlo_text(self) -> str:
        """The traced program, one local op a line in HLO's syntax."""
        return self.recorder.hlo_text()

    def collectives(self) -> hlo_mod.CollectiveSummary:
        return hlo_mod.parse_collectives(self.hlo_text())

    # -- executable broadcast (code-loading channel analogue) ----------------

    def serialize(self) -> bytes:
        """The step exported (``torch.export``) against its example
        arguments, as bytes."""
        import torch

        fn = self.fn

        class _Step(torch.nn.Module):
            def forward(self, *args):
                return fn(*args)

        buf = io.BytesIO()
        torch.export.save(torch.export.export(_Step(), tuple(self.example_args)),
                          buf)
        return buf.getvalue()


# ---------------------------------------------------------------------------
# The builder.
# ---------------------------------------------------------------------------


class ClusterBuilder:
    """Builds deployments from specifications.

    One builder is bound to one mesh (one "cluster"); building the same
    spec with another builder re-deploys it on other hardware with no
    change by the user (paper requirement 4, §6.1)."""

    def __init__(self, mesh=None, rules=None,
                 timing: TimingCollector | None = None):
        self.mesh = mesh
        self.rules = rules
        self.timing = timing or TimingCollector()

    # -- SPMD step path ------------------------------------------------------

    def build_step(self, fn: Callable, example_args: Sequence[Any], *,
                   name: str = "step") -> StepArtifact:
        """Trace ``fn`` once on ``example_args`` and return its artifact.

        ``example_args`` may be real tensors or fake DTensors made by
        ``ShardingRules.struct`` / the ``*_structs`` helpers (the
        dry-run): placements travel with them, so the user supplies none.
        The trace runs under ``FakeTensorMode`` (real arguments are
        converted to fake ones, so nothing is allocated or launched and
        the arguments are not changed) with ``hlo.TraceRecorder`` on.  An
        output that is an input (updated in place, as a train step's
        parameters and moments are) counts as alias bytes: eager PyTorch
        aliases them without the JAX package's ``donate_argnums``.  It is
        timed into the builder's ``TimingCollector`` as host ``load``.
        """
        from repro_torch.core.channels import fake_mode

        t0 = time.perf_counter()
        args = tuple(example_args)
        recorder = hlo_mod.TraceRecorder()
        mode = _fake_mode_of(args) or fake_mode()
        # converted outside the mode: under it, a real DTensor's
        # to_local() would already come back fake
        fake_args = _to_fake(mode, args)
        recorder.fake_only = True
        with mode:
            ins = _unique(_leaves(fake_args))
            with recorder:
                out = fn(*fake_args)
            outs = _unique(_leaves(out))
            in_ids = {id(t) for t in ins}
            alias = sum(_bytes(t) for t in outs if id(t) in in_ids)
            created = sum(_bytes(t) for t in outs if id(t) not in in_ids)
            memory = MemoryAnalysis(
                argument_size_in_bytes=sum(map(_bytes, ins)),
                output_size_in_bytes=sum(map(_bytes, outs)),
                temp_size_in_bytes=max(recorder.peak_bytes - created, 0),
                alias_size_in_bytes=alias,
            )
            del out, outs, ins, fake_args
        load_ms = (time.perf_counter() - t0) * 1e3
        self.timing.add("host", "load", load_ms)
        return StepArtifact(name=name, fn=fn, mesh=self.mesh, load_ms=load_ms,
                            recorder=recorder, memory_analysis=memory,
                            example_args=args)

    @staticmethod
    def load_serialized_step(payload: bytes) -> Callable:
        """Node side: load a step broadcast by the host (paper §4.1)."""
        import torch

        return torch.export.load(io.BytesIO(payload)).module()

    def deployment_plan(
        self,
        spec,
        *,
        hosts: Sequence[str] | None = None,
        bind_host: str | None = None,
        launcher: Any = None,
    ) -> DeploymentPlan:
        """Derive the per-stage deployment plan for a spec.

        Node addresses come from the deployment layer when it is known:
        ``hosts=`` (the ssh fan-out shorthand) or a launcher exposing
        ``.hosts`` assigns machines round-robin exactly as the launcher
        will; otherwise ``bind_host`` (every local node-loader dials it).
        With no deployment information at all — a plan derived from the
        spec alone, as the threads backend's — documentation-placeholder
        addresses are used, as the paper's §4 walkthrough does.
        """
        pipe = spec.as_pipeline() if hasattr(spec, "as_pipeline") else spec
        pipe.validate()
        machines = list(hosts) if hosts else list(
            getattr(launcher, "hosts", None) or []
        )

        def addr_host(i: int) -> str:
            if machines:
                return machines[i % len(machines)]
            if bind_host:
                # Local node-loaders dial the host's bind address; an
                # unroutable wildcard bind resolves to loopback for them.
                return "127.0.0.1" if bind_host == "0.0.0.0" else bind_host
            return f"192.168.1.{100 + i}"  # placeholder: deployment unknown

        nodes: list[NodePlan] = []
        stage_plans: list[StagePlan] = []
        i = 0
        for st in pipe.stages:
            sp = StagePlan(name=st.name, workers=st.workers_per_node)
            for _ in range(st.nclusters):
                np_ = NodePlan(
                    node_id=f"node{i}",
                    address=f"{addr_host(i)}:{LOAD_PORT}/{LOAD_CHANNEL}",
                    workers=st.workers_per_node,
                    stage=st.name if len(pipe.stages) > 1 else "",
                )
                nodes.append(np_)
                sp.nodes.append(np_)
                i += 1
            stage_plans.append(sp)
        return DeploymentPlan(host=pipe.host, nodes=nodes, stages=stage_plans)

    def build_application(self, spec, *, backend: str = "threads",
                          **backend_options):
        """Wire the process network and return a runnable application.

        ``spec`` is a :class:`~repro_torch.core.dsl.ClusterSpec` (the
        paper's emit/cluster/collect shape) or a
        :class:`~repro_torch.core.dsl.PipelineSpec` (one emit, N chained
        stages, one collect); a ClusterSpec is normalised to its one-stage
        pipeline view.

        ``"threads"`` runs threads + rendezvous queues in one process
        (``repro_torch.runtime.local``; the paper's §6.1 single-host
        confidence-building mode).  One option: ``readonly_delivery=True``
        hands work functions read-only ndarray views, mirroring the cluster
        backend's zero-copy delivery semantics so in-place mutation bugs
        surface on one host.

        ``"cluster"`` runs real OS processes connected by TCP sockets via
        the Host-Node-Loader / Node-Loader bootstrap of §4 / Figure 1
        (``repro_torch.cluster``).  ``backend_options`` are forwarded to
        :class:`repro_torch.cluster.spawn.ProcessClusterApplication` (e.g.
        ``port=0``, ``preload=("repro_torch.quickstart",)``,
        ``slowdown={node_id: seconds_per_item}``).  ``launcher=`` takes any
        :class:`~repro_torch.cluster.deploy.base.Launcher` (LocalLauncher
        subprocesses by default, InProcessLauncher threads for tests).  The
        registration barrier is policy-driven: ``min_nodes=`` admits a
        degraded start with survivors, ``max_respawns=`` relaunches a node
        that never registers, late joiners are shipped LOAD + credits
        mid-run (``allow_late_join``).  ``hosts=["ws01", ...]`` is shorthand
        for ssh fan-out over those machines
        (:class:`~repro_torch.cluster.deploy.ssh.SSHLauncher`).  Robustness
        knobs: ``max_heals=`` budgets mid-run pool healing (a node dying
        during the run is relaunched, its code re-shipped) and ``chaos=``
        arms a :class:`repro_torch.cluster.chaos.FaultPlan` of injected
        faults against the live transport.  Work functions cross to the
        nodes pickled (by value through cloudpickle where it is installed,
        else by reference), and ndarray payloads arrive as *read-only*
        views.

        ``"service"`` runs the same process transport over a persistent
        warm node pool (:class:`repro_torch.cluster.service.ClusterService`).
        Pass ``service=`` to run this application as one job of a
        caller-owned pool that stays up (repeat builds of the same spec
        become warm resubmits: no boot, no code shipped); without it an
        ephemeral pool sized from the spec boots for this run and closes
        after.  Remaining ``backend_options`` configure the pool, including
        ``max_heals=`` and ``chaos=``.

        Observability (``"cluster"`` and ``"service"``): ``trace_path=``
        appends every lifecycle event as one JSON line, and ``http_port=``
        turns on the live status endpoint
        (``repro_torch.cluster.telemetry``).
        """
        pipe = spec.as_pipeline() if hasattr(spec, "as_pipeline") else spec
        pipe.validate()
        if backend == "threads":
            readonly = bool(backend_options.pop("readonly_delivery", False))
            if backend_options:
                raise TypeError(
                    f"threads backend takes no options (beyond "
                    f"readonly_delivery), got {sorted(backend_options)}"
                )
            from repro_torch.runtime.local import LocalClusterApplication

            return LocalClusterApplication(
                spec=pipe, plan=self.deployment_plan(pipe),
                timing=self.timing, readonly_delivery=readonly,
            )
        if backend == "cluster":
            from repro_torch.cluster.spawn import ProcessClusterApplication

            # The plan reflects the actual deployment layer: hosts=/launcher
            # machine assignments, or the bind address local loaders dial.
            plan = self.deployment_plan(
                pipe,
                hosts=backend_options.get("hosts"),
                bind_host=backend_options.get("bind_host", "127.0.0.1"),
                launcher=backend_options.get("launcher"),
            )
            return ProcessClusterApplication(
                spec=pipe, plan=plan, timing=self.timing, **backend_options
            )
        if backend == "service":
            from repro_torch.cluster.service import ServiceClusterApplication

            plan = self.deployment_plan(
                pipe,
                hosts=backend_options.get("hosts"),
                bind_host=backend_options.get("bind_host", "127.0.0.1"),
                launcher=backend_options.get("launcher"),
            )
            return ServiceClusterApplication(
                spec=pipe, plan=plan, timing=self.timing, **backend_options
            )
        raise ValueError(
            f"unknown backend {backend!r}; expected 'threads', 'cluster', "
            "or 'service'"
        )
