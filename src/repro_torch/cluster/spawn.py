"""ProcessClusterApplication: cluster lifecycle + deployment policy.

The runnable returned by ``build_application(spec, backend="cluster")``.
*How* node-loaders come into existence is delegated to a pluggable
:class:`~repro_torch.cluster.deploy.base.Launcher` (``repro_torch.cluster.deploy``):
subprocesses on this machine (:class:`LocalLauncher`, the default — the
paper's §6.1 "test on one host first" mode with true process isolation),
or threads for fast launcher-logic tests (:class:`InProcessLauncher`).
The JAX package's ssh fan-out (``hosts=``) and fault injection
(``chaos=``) are not ported yet and raise :class:`NotImplementedError`.
This module does not know what a ``subprocess.Popen`` is.

What remains here is lifecycle and policy: bootstrap the HostLoader, fan
the launches out, relaunch silent nodes when the host's placement policy
asks (``min_nodes`` / ``max_respawns`` / late join — see
:class:`~repro_torch.cluster.deploy.base.PlacementPolicy`), and guarantee that
*no path out of run()/start() leaks a child* — teardown runs even when
bootstrap itself raises midway through the fan-out.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Sequence

from repro_torch.cluster.deploy.base import Launcher, NodeHandle, PlacementPolicy
from repro_torch.cluster.deploy.local import LocalLauncher
from repro_torch.cluster.host_loader import HostLoader
from repro_torch.cluster.telemetry import Telemetry, TelemetryServer
from repro_torch.core.timing import TimingCollector
from repro_torch.runtime.failures import HeartbeatMonitor


@dataclass
class ProcessClusterApplication:
    """Runnable returned by ``build_application(spec, backend="cluster")``.

    Same contract as ``runtime.local.LocalClusterApplication`` — ``run()``
    blocks to completion and returns the finalised result — but the workers
    are real node-loaders started by a :class:`Launcher`.  ``slowdown``
    maps node ids to an artificial seconds-per-item delay (straggler
    injection for §6.1-style testing); ``kill_node`` turns a live node into
    a real mid-job node death.
    """

    spec: Any
    plan: Any
    timing: TimingCollector
    port: int = 0  # 0 = ephemeral; the paper's deployment would fix 2000
    # Defaults tolerate multi-second GC/compile stalls in work functions;
    # tests override with much tighter settings.
    heartbeat_interval: float = 0.5
    heartbeat_misses: int = 10
    job_timeout: float = 300.0
    register_timeout: float = 30.0
    shutdown_grace: float = 10.0
    slowdown: dict[str, float] = field(default_factory=dict)
    # Data-plane knobs (see ARCHITECTURE.md "Data plane"): modules each
    # node pre-imports during boot; extra items beyond `workers` the node
    # keeps buffered (None = one per worker); and the node-side result
    # coalescing threshold/interval.
    preload: tuple[str, ...] = ()
    prefetch: int | None = None
    flush_items: int = 8
    flush_interval: float = 0.005
    # -- deployment layer ---------------------------------------------------
    # Which machines run node-loaders and what happens when one never shows
    # up.  ``launcher=None`` defaults to LocalLauncher (subprocesses here);
    # ``hosts=["ws01", ...]`` (ssh fan-out) is not ported yet.
    # ``bind_host`` is the load-network bind address — keep the loopback
    # default for local runs.
    launcher: Launcher | None = None
    hosts: Sequence[str] | None = None
    bind_host: str = "127.0.0.1"
    min_nodes: int | None = None
    max_respawns: int = 0
    respawn_after: float | None = None
    allow_late_join: bool = True
    # Fault injection (the JAX package's chaos.FaultPlan) is not ported yet.
    chaos: Any = None
    # -- observability ------------------------------------------------------
    # ``http_port``: None = no status endpoint, 0 = ephemeral (read
    # ``http_url`` after start), served on the loopback address.
    http_port: int | None = None
    telemetry: Telemetry = field(default_factory=Telemetry, init=False)
    http_server: TelemetryServer | None = field(default=None, init=False)

    host_loader: HostLoader | None = None
    handles: dict[str, NodeHandle] = field(default_factory=dict)
    result: Any = None
    error: BaseException | None = None  # set by run_async on failure
    _ran: bool = False

    def __post_init__(self) -> None:
        for option, module in (("hosts", "the ssh launcher (cluster/deploy/ssh.py)"),
                               ("chaos", "the fault injector (cluster/chaos.py)")):
            if getattr(self, option) is not None:
                raise NotImplementedError(
                    f"{option}= needs {module}, which is not ported yet "
                    "(ROADMAP.md, queue 1 item 6b: \"Process transport: "
                    "service, gateway, chaos, ssh\")")
        if hasattr(self.spec, "as_pipeline"):
            self.spec = self.spec.as_pipeline()

    # -- compat views (the seed exposed Popen internals) --------------------

    @property
    def processes(self) -> dict[str, NodeHandle]:
        """Per-node handles (named for the era when they were Popens)."""
        return self.handles

    @property
    def node_logs(self) -> dict[str, list[str]]:
        """Last lines of each node-loader's stdout+stderr (diagnostics)."""
        return {nid: h.logs() for nid, h in self.handles.items()}

    def node_ids(self) -> list[str]:
        """Flat node ids, stage order (stage assignment lives in the spec)."""
        return [nid for nid, _ in self.spec.node_assignments()]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Bootstrap the load network and fan out the node-loaders.

        Any failure mid-fan-out (port bind, a launcher raising on the k-th
        node) tears down whatever was already started — bootstrap must
        never leak children.
        """
        try:
            self._start_inner()
        except BaseException:
            self._shutdown()
            raise

    def _start_inner(self) -> None:
        if self.launcher is None:
            self.launcher = LocalLauncher(preload=tuple(self.preload))
        node_ids = self.node_ids()
        self.host_loader = HostLoader(
            self.spec,
            self.timing,
            host=self.bind_host,
            port=self.port,
            heartbeat=HeartbeatMonitor(
                interval_s=self.heartbeat_interval,
                misses=self.heartbeat_misses,
            ),
            register_timeout=self.register_timeout,
            job_timeout=self.job_timeout,
            slowdown=self.slowdown,
            prefetch=self.prefetch,
            flush_items=self.flush_items,
            flush_interval=self.flush_interval,
            placement=PlacementPolicy(
                min_nodes=self.min_nodes,
                max_respawns=self.max_respawns,
                respawn_after=self.respawn_after,
                allow_late_join=self.allow_late_join,
            ),
            expected_nodes=node_ids,
            relaunch=self._relaunch,
            telemetry=self.telemetry,
        )
        if self.http_port is not None and self.http_server is None:
            self.http_server = TelemetryServer(self.telemetry,
                                               port=self.http_port)
        self.host_loader.start()
        # The bind address goes through verbatim: each launcher knows how to
        # resolve an unroutable "0.0.0.0" (loopback for local launchers).
        self.launcher.prepare(self.bind_host, self.host_loader.port)
        for node_id in node_ids:
            self.handles[node_id] = self.launcher.launch(node_id)

    def _relaunch(self, old_node_id: str, new_node_id: str) -> bool:
        """Placement-policy callback: a launch never registered — retire it
        and start a replacement, steering clear of the machine that already
        swallowed one launch."""
        old = self.handles.get(old_node_id)
        avoid = (old.where,) if old is not None else ()
        try:
            self.handles[new_node_id] = self.launcher.launch(
                new_node_id, avoid=avoid
            )
        except Exception:
            return False
        if old is not None:
            try:
                old.kill()  # best effort; it never joined the network
            except Exception:
                pass
        return True

    def run(self) -> Any:
        if self._ran:
            raise RuntimeError("application already ran; build a fresh one")
        self._ran = True
        try:
            if self.host_loader is None:
                self.start()
            self.result = self.host_loader.run()
        finally:
            self._shutdown()
        return self.result

    def run_async(self) -> threading.Thread:
        """Start and run in a background thread (lets callers kill nodes
        mid-job); join the returned thread, then read ``result``/``error``."""

        def target() -> None:
            try:
                self.run()
            except BaseException as exc:  # surfaced via .error, not stderr
                self.error = exc

        t = threading.Thread(target=target, name="cluster-app", daemon=True)
        t.start()
        return t

    def kill_node(self, node_id: str) -> None:
        """Hard-kill a node-loader: a real workstation loss, detected only
        by its heartbeats going silent."""
        self.handles[node_id].kill()

    # -- teardown -----------------------------------------------------------

    def _shutdown(self) -> None:
        # Close the host's sockets first: surviving node-loaders blocked on
        # the application channel see ChannelClosed and exit promptly
        # (milliseconds, exit 0) instead of burning the grace period.
        if self.host_loader is not None:
            self.host_loader.close()
        deadline = time.monotonic() + self.shutdown_grace
        for handle in self.handles.values():
            remaining = max(0.0, deadline - time.monotonic())
            if handle.wait(timeout=remaining) is None:
                handle.kill()
                handle.wait(timeout=self.shutdown_grace)
        for handle in self.handles.values():
            join = getattr(handle, "join_drainers", None)
            if join is not None:  # EOF arrives once the child exits
                join()
        if self.launcher is not None:
            self.launcher.close()
        if self.http_server is not None:
            self.http_server.close()
        self.telemetry.close()

    @property
    def http_url(self) -> str | None:
        """Base URL of the status endpoint (None when not serving)."""
        return None if self.http_server is None else self.http_server.url

    def metrics_snapshot(self) -> dict[str, Any]:
        """The ``GET /metrics`` JSON as a dict (usable after shutdown too —
        the bus outlives the sockets)."""
        return self.telemetry.snapshot()

    def orphaned(self) -> list[str]:
        """Node-loaders still running after shutdown (must be empty)."""
        return [nid for nid, h in self.handles.items() if h.poll() is None]
