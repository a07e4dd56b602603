"""ClusterService: a persistent warm node pool that runs many jobs.

The paper's deployment is one-shot — boot the cluster, run the farm, tear
everything down — so every run pays the full §8.2 boot/load bill.  This
module keeps the Host-Node-Loader topology *up* between jobs:

* the pool boots **once** (``start()``): launcher fan-out, REGISTER
  barrier, pool-config LOAD — the entire §4 bootstrap, paid exactly once;
* ``submit(spec, ...)`` hands a pipeline to the resident
  :class:`~repro_torch.cluster.host_loader.HostLoader` dispatcher and returns a
  :class:`JobHandle` future immediately — jobs run back-to-back *and*
  concurrently, interleaved over the same nodes with exactly-once
  preserved per job (every wire frame carries its ``job_id``);
* resubmitting a pipeline whose stage functions the nodes still hold in
  their digest-keyed code cache ships no code at all — a warm job pays
  neither boot nor load (``JobHandle.cluster_boot_ms == 0`` and
  ``stats()["code_shipped"] == 0``);
* ``close()`` (or the context manager) terminates the pool: UT to every
  node, timing records collected, launcher resources reclaimed — the same
  no-orphan guarantee as the one-shot application.

Scheduling is FIFO-with-priority: when a node demands work, the dispatcher
answers from the highest-``priority`` admitted job first (ties in
submission order).  The pool's geometry (``nodes`` × ``workers``) is fixed
at boot — a submitted spec's ``nclusters``/``workers`` describe its
*logic*, not a reservation; every pool node serves every stage of every
job.  Likewise per-stage ``prefetch=``/``flush_ms=`` overrides apply to
the one-shot pinned deployment, not to a shared pool (whose data-plane
cadence is a pool property, set here).

``build_application(spec, backend="service")`` wraps this in the standard
application contract (:class:`ServiceClusterApplication`): an ephemeral
pool sized from the spec, or — pass ``service=`` — a caller-owned warm
pool that outlives the application.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Sequence

from repro_torch.cluster.deploy.base import Launcher, NodeHandle, PlacementPolicy
from repro_torch.cluster.host_loader import HostLoader, JobState
from repro_torch.cluster.membership import LAUNCHING
from repro_torch.cluster.telemetry import Telemetry, TelemetryServer
from repro_torch.core.timing import TimingCollector
from repro_torch.runtime.failures import HeartbeatMonitor

__all__ = ["ClusterService", "JobHandle", "ServiceClusterApplication"]


class JobHandle:
    """A submitted job's future: wait on it, read its result and timings.

    When the submission carried a retry policy (``submit(..., retries=N)``),
    the handle spans *all* attempts: ``done()``/``wait()``/``result()``
    resolve only once the supervisor declares the job final (succeeded, or
    out of retries — the poisoned-job guard), and ``attempts`` /
    ``stats()["attempts"]`` record each attempt's outcome, failure cause,
    implicated node and timing.
    """

    def __init__(self, job: JobState, cluster_boot_ms: float,
                 host_loader: HostLoader | None = None):
        self._job = job
        self._host_loader = host_loader
        #: What this submission paid for cluster boot: the pool's boot time
        #: on the submission that triggered it, ``0.0`` on every warm one.
        self.cluster_boot_ms = cluster_boot_ms
        #: One record per finished attempt (retry submissions only fill
        #: more than one): attempt #, job_id, error, cause, node, timings.
        self.attempts: list[dict[str, Any]] = []
        # Retry mode: the supervisor sets this once no further attempt
        # will run; without retries the job's own event is the signal.
        self._final: threading.Event | None = None

    @property
    def job_id(self) -> int:
        return self._job.job_id

    def _event(self) -> threading.Event:
        return self._final if self._final is not None else self._job.done

    def done(self) -> bool:
        return self._event().is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event().wait(timeout)

    def result(self, timeout: float | None = None) -> Any:
        if not self._event().wait(timeout):
            raise TimeoutError(
                f"job {self._job.job_id} not finished within {timeout}s"
            )
        if self._job.error is not None:
            raise self._job.error
        return self._job.result

    @property
    def error(self) -> BaseException | None:
        return self._job.error

    @property
    def submit_to_first_result_ms(self) -> float | None:
        """Latency from submit() to the first collected result (None until
        one arrives) — the end-to-end figure the warm pool exists to cut."""
        if (self._job.submitted_at is None
                or self._job.first_result_at is None):
            return None
        return (self._job.first_result_at - self._job.submitted_at) * 1e3

    def stats(self) -> dict[str, Any]:
        # Per-node attribution: which pool members did this job's work,
        # whether each got its code warm, and (when the pool is reachable)
        # the node's connection-level wire counters.  Sums reconcile with
        # the job-level figures: sum(items) == items_collected + forwarded,
        # sum(cache_hits) == code_cached, sum(cache_misses) == code_shipped.
        nodes: dict[str, dict[str, Any]] = {}
        for nid, n in self._job.items_by_node.items():
            nodes.setdefault(nid, {})["items"] = n
        for nid, cache in self._job.cache_by_node.items():
            d = nodes.setdefault(nid, {})
            d["cache_hits"] = cache["hits"]
            d["cache_misses"] = cache["misses"]
        if self._host_loader is not None:
            for nid, d in nodes.items():
                rec = self._host_loader.membership.nodes.get(nid)
                if rec is not None and rec.conn is not None:
                    d["wire"] = rec.conn.counters.as_dict()
        # The attempt history always shows at least the current attempt,
        # even mid-flight or without a retry policy, so consumers need not
        # special-case the no-retry path.
        attempts = list(self.attempts)
        if not attempts or attempts[-1]["job_id"] != self._job.job_id:
            attempts.append(_attempt_record(self._job, len(attempts) + 1))
        stats = {
            "job_id": self._job.job_id,
            "priority": self._job.priority,
            "items_collected": self._job.items_collected,
            "duplicates_dropped": self._job.duplicates_dropped,
            "forwarded": self._job.forwarded,
            # Peer data plane: hop items shipped node-to-node vs the
            # payload bytes that still relayed through the host (0 on a
            # fully peer-routed hop — the acceptance figure).
            "peer_forwarded": self._job.peer_forwarded,
            "host_relay_bytes": self._job.host_relay_bytes,
            # Warm-load accounting: stage functions shipped by value vs
            # rebound from the nodes' digest-keyed code caches.
            "code_shipped": self._job.code_shipped,
            "code_cached": self._job.code_cached,
            "cluster_boot_ms": self.cluster_boot_ms,
            "submit_to_first_result_ms": self.submit_to_first_result_ms,
            "nodes": nodes,
            "attempts": attempts,
            "retries": max(0, len(attempts) - 1),
        }
        if self._host_loader is not None:
            # Pool-level healing the job rode through (cluster-wide
            # counters: the pool, not this job alone, was healed).
            stats["respawns"] = self._host_loader.stats.respawns
            stats["heals"] = self._host_loader.stats.heals
        return stats


def _attempt_record(job: JobState, attempt: int) -> dict[str, Any]:
    elapsed_ms = None
    if job.submitted_at is not None and job.ended_at is not None:
        elapsed_ms = round((job.ended_at - job.submitted_at) * 1e3, 3)
    return {
        "attempt": attempt,
        "job_id": job.job_id,
        "done": job.done.is_set(),
        "error": None if job.error is None else str(job.error),
        "error_type": (None if job.error is None
                       else type(job.error).__name__),
        "cause": job.failure_kind,
        "node": job.failed_node,
        "items_collected": job.items_collected,
        "elapsed_ms": elapsed_ms,
    }


class ClusterService:
    """A long-lived node pool multiplexing many jobs (see module docstring).

    Construction is cheap; ``start()`` (or the first ``submit``, or
    entering the context manager) boots the pool.
    """

    def __init__(
        self,
        *,
        nodes: int = 1,
        workers: int = 1,
        launcher: Launcher | None = None,
        hosts: Sequence[str] | None = None,
        bind_host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_interval: float = 0.5,
        heartbeat_misses: int = 10,
        register_timeout: float = 30.0,
        prefetch: int | None = None,
        flush_items: int = 8,
        flush_interval: float = 0.005,
        preload: tuple[str, ...] = (),
        artifacts: dict[str, bytes] | None = None,
        min_nodes: int | None = None,
        max_respawns: int = 0,
        respawn_after: float | None = None,
        allow_late_join: bool = True,
        max_heals: int = 0,
        chaos: Any = None,
        shutdown_grace: float = 10.0,
        timing: TimingCollector | None = None,
        telemetry: Telemetry | None = None,
        trace_path: str | None = None,
        http_host: str = "127.0.0.1",
        http_port: int | None = None,
    ):
        if launcher is not None and hosts is not None:
            raise TypeError("pass either launcher= or hosts=, not both")
        if nodes < 1:
            raise ValueError(f"nodes must be >= 1, got {nodes}")
        self.nodes = nodes
        self.workers = workers
        self.launcher = launcher
        self.hosts = hosts
        self.bind_host = bind_host
        self.port = port
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_misses = heartbeat_misses
        self.register_timeout = register_timeout
        self.prefetch = prefetch
        self.flush_items = flush_items
        self.flush_interval = flush_interval
        self.preload = tuple(preload)
        self.artifacts = dict(artifacts or {})
        self.min_nodes = min_nodes
        self.max_respawns = max_respawns
        self.respawn_after = respawn_after
        self.allow_late_join = allow_late_join
        # Mid-run healing budget: a node dying while jobs run is answered
        # with a replacement launch (0 = shrink to survivors, the
        # historical behaviour).
        self.max_heals = max_heals
        # Optional fault injection: a repro_torch.cluster.chaos.FaultPlan armed
        # against this pool once it is ready (tests, chaos-smoke CI).
        self.chaos = chaos
        self.chaos_controller: Any = None
        self.shutdown_grace = shutdown_grace
        self.timing = timing or TimingCollector()
        # Observability: one bus for the pool's whole life.  ``http_port``
        # None = no endpoint; 0 = an ephemeral port (read ``.http_url``);
        # ``trace_path`` appends every lifecycle event as one JSON line.
        self.telemetry = telemetry or Telemetry(trace_path=trace_path)
        self.http_host = http_host
        self.http_port = http_port
        self.http_server: TelemetryServer | None = None

        self.host_loader: HostLoader | None = None
        self.handles: dict[str, NodeHandle] = {}
        # Elastic growth: the next fresh node id (``grow()`` continues the
        # ``node<i>`` sequence past the boot-time pool).
        self._node_seq = nodes
        self.boot_ms: float | None = None
        self._boot_charged = False
        self._stop = threading.Event()
        self._serve_thread: threading.Thread | None = None
        self._closed = False
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ClusterService":
        """Boot the pool: launch node-loaders, run the REGISTER barrier,
        ship the pool-config LOAD.  Idempotent; returns self."""
        with self._lock:
            if self.host_loader is not None:
                return self
            if self._closed:
                raise RuntimeError("service already closed")
            t0 = time.perf_counter()
            try:
                self._start_inner()
            except BaseException:
                self._teardown()
                raise
            self.boot_ms = (time.perf_counter() - t0) * 1e3
            return self

    def _start_inner(self) -> None:
        if self.launcher is None:
            if self.hosts is not None:
                from repro_torch.cluster.deploy.ssh import SSHLauncher

                self.launcher = SSHLauncher(self.hosts,
                                            preload=self.preload)
            else:
                from repro_torch.cluster.deploy.local import LocalLauncher

                self.launcher = LocalLauncher(preload=self.preload)
        node_ids = [f"node{i}" for i in range(self.nodes)]
        conn_wrapper = None
        if self.chaos is not None and self.chaos_controller is None:
            from repro_torch.cluster.chaos import ChaosController

            self.chaos_controller = ChaosController(
                self.chaos,
                kill=self._chaos_kill,
                telemetry=self.telemetry,
                items_fn=self._chaos_items,
            )
            self.telemetry.set_sampler("chaos", self.chaos_controller.sample)
        if self.chaos_controller is not None:
            conn_wrapper = self.chaos_controller.wrap_connection
        self.host_loader = HostLoader(
            None,
            self.timing,
            host=self.bind_host,
            port=self.port,
            heartbeat=HeartbeatMonitor(
                interval_s=self.heartbeat_interval,
                misses=self.heartbeat_misses,
            ),
            register_timeout=self.register_timeout,
            artifacts=self.artifacts,
            prefetch=self.prefetch,
            flush_items=self.flush_items,
            flush_interval=self.flush_interval,
            placement=PlacementPolicy(
                min_nodes=self.min_nodes,
                max_respawns=self.max_respawns,
                respawn_after=self.respawn_after,
                allow_late_join=self.allow_late_join,
                max_heals=self.max_heals,
            ),
            expected_nodes=node_ids,
            relaunch=self._relaunch,
            pool_nodes=self.nodes,
            pool_workers=self.workers,
            telemetry=self.telemetry,
            conn_wrapper=conn_wrapper,
        )
        # The endpoint comes up before the barrier so an operator can watch
        # LAUNCHING -> REGISTERED -> LOADED roll in live.
        if self.http_port is not None and self.http_server is None:
            self.http_server = TelemetryServer(
                self.telemetry, host=self.http_host, port=self.http_port,
            )
        self.host_loader.start()
        self.launcher.prepare(self.bind_host, self.host_loader.port)
        for node_id in node_ids:
            self.handles[node_id] = self.launcher.launch(node_id)
        self._serve_thread = threading.Thread(
            target=self.host_loader.serve, args=(self._stop,),
            name="cluster-service", daemon=True,
        )
        self._serve_thread.start()
        # The barrier runs on the serve thread; block until the pool is
        # usable (or its bootstrap failed) so boot_ms means what it says.
        self.host_loader.pool_ready.wait()
        if self.host_loader.serve_error is not None:
            raise self.host_loader.serve_error
        # Arm chaos only against the *running* pool — faults during the
        # bootstrap barrier would test the launcher, not the protocol.
        if self.chaos_controller is not None:
            self.chaos_controller.arm()

    def _chaos_kill(self, node_id: str) -> bool:
        handle = self.handles.get(node_id)
        if handle is None:
            return False
        handle.kill()
        return True

    def _chaos_items(self) -> int:
        hl = self.host_loader
        return hl.stats.items_total if hl is not None else 0

    def _relaunch(self, old_node_id: str, new_node_id: str) -> bool:
        old = self.handles.get(old_node_id)
        avoid = (old.where,) if old is not None else ()
        try:
            handle = self.launcher.launch(new_node_id, avoid=avoid)
        except Exception:
            return False
        with self._lock:  # close()/orphaned() snapshot under it
            self.handles[new_node_id] = handle
        if old is not None:
            try:
                old.kill()  # best effort; it never joined the network
            except Exception:
                pass
        return True

    # -- jobs ---------------------------------------------------------------

    def submit(self, spec, *, priority: int = 0,
               timeout: float | None = None, retries: int = 0,
               backoff: float = 0.5, max_backoff: float = 30.0,
               tenant: str = "default",
               max_inflight: int | None = None) -> JobHandle:
        """Submit one pipeline; returns immediately with its future.

        The first submission is charged the pool's boot time in its
        ``cluster_boot_ms`` (booting lazily if ``start()`` was never
        called); every later one reports ``0.0`` — it ran warm.

        ``retries`` arms a per-job retry policy: a failed attempt is
        resubmitted up to that many times with exponential backoff
        (``backoff * 2**(attempt-1)``, capped at ``max_backoff``, with
        ±50% jitter so a burst of failed jobs doesn't resubmit in
        lockstep).  The handle resolves once an attempt succeeds or the
        budget is spent (the poisoned-job guard: a deterministically
        failing work function stops, with the full history on
        ``handle.attempts``).  Each attempt gets its own ``timeout``.

        ``tenant``/``max_inflight`` are the gateway's fairness plumbing:
        all jobs of one tenant share a host-dispatched in-flight item
        budget in the dispatcher (see ``JobState``); direct users can
        leave the defaults.
        """
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if backoff < 0 or max_backoff < 0:
            raise ValueError("backoff and max_backoff must be >= 0")
        self.start()
        if self._stop.is_set() or self._closed:
            raise RuntimeError("cluster service is closed")
        job = self.host_loader.submit_job(spec, priority=priority,
                                          timeout=timeout, tenant=tenant,
                                          max_inflight=max_inflight)
        with self._lock:
            boot = 0.0 if self._boot_charged else (self.boot_ms or 0.0)
            self._boot_charged = True
        handle = JobHandle(job, cluster_boot_ms=boot,
                           host_loader=self.host_loader)
        if retries > 0:
            handle._final = threading.Event()
            t = threading.Thread(
                target=self._supervise_retries,
                args=(handle, spec, priority, timeout, retries, backoff,
                      max_backoff, tenant, max_inflight),
                name=f"job-retry-{job.job_id}", daemon=True,
            )
            t.start()
        return handle

    def _supervise_retries(self, handle: JobHandle, spec, priority: int,
                           timeout: float | None, retries: int,
                           backoff: float, max_backoff: float,
                           tenant: str = "default",
                           max_inflight: int | None = None) -> None:
        """Per-job retry loop (its own daemon thread; the dispatcher never
        blocks on a backoff).  Records every attempt on the handle and in
        the telemetry job gauges, resubmits failed attempts until the
        budget is spent, then declares the handle final."""
        rng = random.Random(handle._job.job_id)
        attempt = 1
        while True:
            job = handle._job
            job.done.wait()
            record = _attempt_record(job, attempt)
            handle.attempts.append(record)
            self.telemetry.set_job(job.job_id,
                                   attempts=list(handle.attempts),
                                   retries=attempt - 1)
            if (job.error is None or attempt > retries
                    or self._stop.is_set() or self._closed):
                break
            delay = min(max_backoff, backoff * (2 ** (attempt - 1)))
            delay *= rng.uniform(0.5, 1.5)
            record["backoff_ms"] = round(delay * 1e3, 3)
            self.telemetry.inc("job_retries")
            self.telemetry.emit("job_retry", job=job.job_id,
                                attempt=attempt, cause=record["cause"],
                                node=record["node"],
                                backoff_ms=record["backoff_ms"])
            if self._stop.wait(delay):
                break
            attempt += 1
            try:
                new_job = self.host_loader.submit_job(
                    spec, priority=priority, timeout=timeout,
                    tenant=tenant, max_inflight=max_inflight)
            except Exception:
                break  # service torn down under us: the last error stands
            handle._job = new_job
        handle._final.set()

    def run(self, spec, *, priority: int = 0,
            timeout: float | None = None) -> Any:
        """Submit and block: the one-shot ``run()`` as a single warm job."""
        return self.submit(spec, priority=priority, timeout=timeout).result()

    def kill_node(self, node_id: str) -> None:
        """Hard-kill one pool node: a real workstation loss, detected only
        by its heartbeats going silent (in-flight work is redispatched)."""
        self.handles[node_id].kill()

    # -- elasticity ----------------------------------------------------------

    def grow(self, n: int = 1, *, reason: str = "manual") -> list[str]:
        """Add ``n`` fresh nodes to the running pool via the mid-run
        late-join path: each launch is announced to the dispatcher first
        (so its REGISTER takes the expected-arrival path even with
        elastic late join disabled), then launched; on registration it
        receives the pool config, every active job's LOAD, and the peer
        directory broadcast.  Returns the launched node ids without
        waiting for them to boot; an announcement whose launch fails is
        retracted (never left as phantom LAUNCHING capacity), and if
        nothing launched at all the failure is re-raised."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        self.start()
        if self._stop.is_set() or self._closed:
            raise RuntimeError("cluster service is closed")
        with self._lock:
            new_ids = []
            for _ in range(n):
                new_ids.append(f"node{self._node_seq}")
                self._node_seq += 1
        self.host_loader.expect_nodes(new_ids)
        launched: list[str] = []
        failed: list[str] = []
        error: Exception | None = None
        for node_id in new_ids:
            try:
                handle = self.launcher.launch(node_id)
            except Exception as exc:
                failed.append(node_id)
                error = exc
                continue
            with self._lock:  # close()/orphaned() snapshot under it
                self.handles[node_id] = handle
            launched.append(node_id)
        if failed:
            # Withdraw the announcements: a LAUNCHING record with no
            # process behind it would count as capacity on its way
            # forever — suppressing autoscale scale-ups (pool_span) and
            # keeping stages eligible (_check_liveness).
            self.host_loader.retract_nodes(failed)
            self.telemetry.emit("scale_up_failed", nodes=failed,
                                reason=reason, error=str(error))
        if launched:
            self.telemetry.inc("scale_up_events", len(launched))
            self.telemetry.emit("scale_up", nodes=launched, reason=reason,
                                pool=len(self.handles))
        elif error is not None:
            raise error
        return launched

    def shrink(self, node_id: str | None = None, *,
               reason: str = "manual") -> str | None:
        """Gracefully retire one pool node (default: the newest live one):
        the dispatcher fences it from new work and sends UT — the node
        drains its queued items, flushes, returns its timing record and
        exits; in-flight items are requeued on the ack.  Returns the
        retired node id, or None when nothing is retirable (the last live
        node never is)."""
        if self.host_loader is None or self._stop.is_set() or self._closed:
            return None
        candidates = self.pool_alive()
        if len(candidates) <= 1:
            return None
        if node_id is None:
            node_id = candidates[-1]
        elif node_id not in candidates:
            return None
        self.host_loader.retire_node(node_id)
        return node_id

    def pool_alive(self) -> list[str]:
        """Live, non-retiring pool members in registration order (a
        cross-thread snapshot — authoritative checks re-run on the
        dispatcher)."""
        hl = self.host_loader
        if hl is None:
            return []
        for _ in range(8):
            try:
                recs = sorted(hl.membership.nodes.values(),
                              key=lambda r: r.index)
                return [r.node_id for r in recs
                        if r.alive and not r.retiring]
            except RuntimeError:
                continue
        return []

    def pool_span(self) -> tuple[int, int]:
        """(alive, launching) member counts — the autoscaler's view of
        capacity present and capacity already on its way.  A LAUNCHING
        record older than the register timeout is not counted: a launch
        whose process died before REGISTER would otherwise read as
        capacity forever and suppress every future scale-up."""
        hl = self.host_loader
        if hl is None:
            return (0, 0)
        now = time.monotonic()
        for _ in range(8):
            try:
                recs = list(hl.membership.nodes.values())
                alive = sum(1 for r in recs if r.alive and not r.retiring)
                launching = sum(
                    1 for r in recs
                    if r.state == LAUNCHING
                    and now - r.state_changed_at < hl.register_timeout)
                return (alive, launching)
            except RuntimeError:
                continue
        return (0, 0)

    def publish_block(self, name: str, data: bytes) -> str:
        """Publish a named read-only broadcast block to the pool.

        Returns its digest.  Nodes stripe the initial chunk fetches across
        themselves against the host and then trade chunks peer-to-peer, so
        the payload leaves the host roughly once regardless of pool size;
        work functions read it with ``repro_torch.cluster.peer.get_block(name)``.
        """
        self.start()
        if self._stop.is_set() or self._closed:
            raise RuntimeError("cluster service is closed")
        return self.host_loader.publish_block(name, data)

    # -- observability ------------------------------------------------------

    @property
    def http_url(self) -> str | None:
        """Base URL of the status endpoint (None when not serving)."""
        return None if self.http_server is None else self.http_server.url

    def metrics_snapshot(self) -> dict[str, Any]:
        """The same JSON ``GET /metrics`` serves, as a dict — a caller can
        record it next to its timing numbers."""
        return self.telemetry.snapshot()

    # -- teardown -----------------------------------------------------------

    def close(self) -> None:
        """Terminate the pool: UT every node, collect their timing records,
        reclaim launcher resources.  Pending jobs are failed, not leaked."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._teardown()

    def _teardown(self) -> None:
        # Chaos first: no new faults may fire into a pool being dismantled.
        if self.chaos_controller is not None:
            self.chaos_controller.disarm()
        if self.host_loader is not None:
            # Polite first: UT lets nodes flush + return timings and exit 0.
            self.host_loader.shutdown_nodes()
            # The dispatcher records a node's answer to UT (its timing) only
            # while it runs: stop it once no node is left to answer, or at
            # the grace deadline.
            deadline = time.monotonic() + self.shutdown_grace
            while (self._serve_thread is not None
                   and self._serve_thread.is_alive()
                   and time.monotonic() < deadline
                   and any(rec.alive
                           for rec in self.host_loader._member_snapshot())):
                time.sleep(0.01)
        self._stop.set()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=self.shutdown_grace)
        if self.host_loader is not None:
            self.host_loader.close()
        deadline = time.monotonic() + self.shutdown_grace
        with self._lock:
            # Snapshot: grow()/_relaunch() mutate handles from the
            # autoscaler and dispatcher threads.
            handles = list(self.handles.values())
        for handle in handles:
            remaining = max(0.0, deadline - time.monotonic())
            if handle.wait(timeout=remaining) is None:
                handle.kill()
                handle.wait(timeout=self.shutdown_grace)
        for handle in handles:
            join = getattr(handle, "join_drainers", None)
            if join is not None:  # EOF arrives once the child exits
                join()
        if self.launcher is not None:
            self.launcher.close()
        if self.http_server is not None:
            self.http_server.close()
        self.telemetry.close()  # flush the trace even if start() never ran

    def orphaned(self) -> list[str]:
        """Node-loaders still running after close (must be empty)."""
        with self._lock:
            items = list(self.handles.items())
        return [nid for nid, h in items if h.poll() is None]

    def __enter__(self) -> "ClusterService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


class ServiceClusterApplication:
    """``build_application(spec, backend="service")``: the app contract over
    a warm pool.

    With ``service=`` the caller's pool is used and **left running** —
    ``run()`` is just "submit this job and wait", which is how repeated
    builds of the same spec become warm resubmits.  Without it, an
    ephemeral pool sized from the spec (its total nodes, its widest
    stage's workers) boots for this run and closes after — behaviourally
    the one-shot cluster backend, routed through the service code path.
    """

    def __init__(self, spec: Any, plan: Any, timing: TimingCollector,
                 service: ClusterService | None = None,
                 priority: int = 0, job_timeout: float | None = 300.0,
                 **pool_options: Any):
        if hasattr(spec, "as_pipeline"):
            spec = spec.as_pipeline()
        spec.validate()
        self.spec = spec
        self.plan = plan
        self.timing = timing
        self.priority = priority
        self.job_timeout = job_timeout
        self.service = service
        self._owns_service = service is None
        self._pool_options = pool_options
        self.handle: JobHandle | None = None
        self.result: Any = None
        self._ran = False

    def run(self) -> Any:
        if self._ran:
            raise RuntimeError("application already ran; build a fresh one")
        self._ran = True
        if self.service is None:
            self.service = ClusterService(
                nodes=self.spec.total_nodes,
                workers=max(st.workers_per_node for st in self.spec.stages),
                timing=self.timing,
                **self._pool_options,
            )
        try:
            self.handle = self.service.submit(
                self.spec, priority=self.priority, timeout=self.job_timeout,
            )
            self.result = self.handle.result()
        finally:
            if self._owns_service:
                self.service.close()
        return self.result

    def orphaned(self) -> list[str]:
        if self.service is None or not self._owns_service:
            return []
        return self.service.orphaned()
