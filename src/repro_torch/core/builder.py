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
  whose protocol is the one model-checked by ``core.verify``.

This is the application half of the JAX package's builder.  Its SPMD half
(``build_step``) and the ``"service"`` backend are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

from repro_torch.core.timing import TimingCollector


LOAD_PORT = 2000  # paper §6: the load network uses port 2000 ...
LOAD_CHANNEL = 1  # ... and channel number 1 on every node.
APP_PORT = 3000  # application network runs on a different port (§6.1).


# ---------------------------------------------------------------------------
# Deployment plan (HNL / NL analogue).
# ---------------------------------------------------------------------------


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
# The builder.
# ---------------------------------------------------------------------------


class ClusterBuilder:
    """Builds deployments from specifications."""

    def __init__(self, timing: TimingCollector | None = None):
        self.timing = timing or TimingCollector()

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
        mid-run (``allow_late_join``).  Work functions cross to the nodes
        pickled (by value through cloudpickle where it is installed, else by
        reference), and ndarray payloads arrive as *read-only* views.
        ``http_port=`` turns on the live status endpoint
        (``repro_torch.cluster.telemetry``).  ``hosts=`` (ssh fan-out) and
        ``chaos=`` (fault injection) are not ported yet and raise
        :class:`NotImplementedError`.

        ``"service"`` (the persistent warm node pool) is not ported yet and
        raises :class:`NotImplementedError`.
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
            raise NotImplementedError(
                "backend 'service' needs the warm node pool "
                "(cluster/service.py), which is not ported yet (ROADMAP.md, "
                "queue 1 item 6b: \"Process transport: service, gateway, "
                "chaos, ssh\")"
            )
        raise ValueError(
            f"unknown backend {backend!r}; expected 'threads', 'cluster', "
            "or 'service'"
        )
