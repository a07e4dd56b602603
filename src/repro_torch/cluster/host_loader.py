"""The Host-Node-Loader (HNL): paper §4 / Figure 1, over real sockets.

Bootstrap sequence (the load network):

1. HNL listens on the configurable "port 2000" and waits for one REGISTER
   frame per expected node (many-to-one input channel — input end created
   before any output end exists, §4's ordering rule).
2. As *each* node registers, the HNL immediately sends it the serialized
   deployment on a LOAD frame — the JCSP *code-loading channel* analogue
   (§4.1).  Early registrants therefore deserialize code and pull in heavy
   imports while stragglers are still connecting, instead of the whole
   cluster idling until the last REGISTER.
3. The application network then runs the demand-driven onrl/nrfa
   client-server protocol model-checked in ``core.verify``, pipelined:
   a WORK_REQUEST carries a *credit count* and the host answers with up to
   that many items in one WORK_BATCH frame; each RESULT_BATCH a node sends
   both delivers results and (piggybacked ``credits``) re-requests that
   many replacement items.  The CSP obligation is unchanged — every demand
   is answered in finite time with items or, once the node's input stream
   is exhausted and nothing is in flight, with UT — the window is just
   wider than one.
4. On UT each node returns its (boot_ms, load_ms, run_ms, items) timing
   record (requirement 7) and the HNL folds results via the user's
   ResultDetails.

Multi-job multiplexing (wire v2): the HNL is a *job dispatcher*, not a
one-shot farm.  All per-farm state — per-stage pending/in-flight/dedup
queues, the emit generator, the collector accumulator — lives in a
:class:`JobState` keyed by the frame-header ``job_id``, so two jobs can
interleave on the same node pool with exactly-once preserved per job.  The
classic one-shot ``run()`` is simply "one pinned job admitted at
construction, dispatch until it completes"; a warm
:class:`~repro_torch.cluster.service.ClusterService` instead constructs the
HostLoader in *pool mode* (``spec=None, pool_nodes=N``) and drives
``serve()`` on a background thread, feeding jobs in through
``submit_job``.  Scheduling is FIFO-with-priority: parked node credits are
answered from the highest-priority admitted job that has (a) pending items
and (b) acked its LOAD on that node (``NodeRecord.jobs_loaded`` — work for
a job never races ahead of its code).

Warm code shipping: each stage function is pickled once per job and
addressed by digest.  The host mirrors every node's code-cache LRU
(``NodeRecord.code_digests``, same capacity and touch order — frames
arrive in send order on one TCP stream), so a resubmission of the same
pipeline ships ``function=None`` and the node rebinds from cache: ~0ms
load on top of the pool's ~0ms boot.

Multi-stage routing (``PipelineSpec``): every one-shot node belongs to one
stage; the host keeps *per-stage* pending/in-flight/dedup state and
answers a node's credits only from its own stage's queue.  A RESULT_BATCH
from a stage-*s* node is deduplicated and its values re-enter the host as
fresh WORK items of stage *s+1* (the final stage folds into the collector)
— the host is the rendezvous between hops, exactly as the chained CSP
model has reducer *s* feeding server *s+1*.  Stage *s*'s input is
exhausted once the emit stream (s = 0) or stage *s-1* (s > 0) has fully
drained, at which point parked credits of stage-*s* nodes are answered
with UT.  Exactly-once holds per stage *per job*: result-id dedup before
forwarding means a redispatched zombie's duplicate can neither
double-collect nor double-forward.  Pool-mode nodes are not pinned — any
node serves any stage of any job (items carry their stage index ``s``).

Beyond the paper: heartbeat liveness (``membership``) — a node-loader that
dies mid-job is detected by missed beats, its in-flight items re-queued and
re-dispatched to surviving nodes (their parked credits answered first), with
result-id dedup guaranteeing no item is lost or double-collected.

Single-threaded protocol core: per-connection reader threads and a ticker
only *enqueue* events; one dispatcher consumes them.  That makes the state
machine deterministic and trivially deadlock-free (no locks around protocol
state).
"""

from __future__ import annotations

import collections
import hashlib
import queue
import socket
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

from repro_torch.cluster.deploy.base import PlacementPolicy
from repro_torch.cluster.membership import (
    LAUNCHING,
    REPLACED,
    Membership,
    NodeRecord,
)
from repro_torch.cluster import peer as peer_mod
from repro_torch.cluster.telemetry import Telemetry
from repro_torch.cluster.wire import (
    APP_WIRE_CHANNEL,
    CODE_CACHE_SLOTS,
    LOAD_WIRE_CHANNEL,
    Frame,
    FrameConnection,
    FrameType,
    _buffers_len,
    dumps_code,
    encode_payload,
)
from repro_torch.core.timing import TimingCollector
from repro_torch.runtime.failures import HeartbeatMonitor, WorkFunctionError

__all__ = ["HostLoader", "HostStats", "JobState", "WorkFunctionError"]


@dataclass
class HostStats:
    items_total: int = 0
    duplicates_dropped: int = 0
    redispatched: int = 0
    deaths_detected: int = 0
    forwarded: int = 0  # stage-s results re-entered as stage-s+1 work items
    # Data-plane counters (credit pipeline).
    work_requests: int = 0  # explicit WORK_REQUEST frames received
    work_batches: int = 0  # WORK_BATCH frames sent
    result_batches: int = 0  # RESULT/RESULT_BATCH frames received
    max_batch: int = 0  # largest WORK_BATCH dispatched
    # Placement-policy counters (deployment layer).
    respawns: int = 0  # launches relaunched elsewhere (bootstrap + heals)
    heals: int = 0  # mid-run deaths answered with a replacement launch
    late_joins: int = 0  # nodes admitted after the run started
    degraded_start: bool = False  # job admitted below full strength
    # Peer data-plane counters (the host demoted to control plane).
    item_acks: int = 0  # ITEM_ACK frames received
    peer_forwarded: int = 0  # hop items shipped node-to-node (acked)
    peer_redispatched: int = 0  # peer-stranded items recomputed upstream
    host_relay_bytes: int = 0  # stage-hop payload bytes relayed via host


class JobState:
    """All farm state of one submitted job, keyed by its wire ``job_id``.

    Exactly the per-stage state the one-shot host kept in run()-local
    variables, plus lifecycle (``done``/``error``/``result``) so service
    callers can wait on a job like a future.  Mutated only by the
    dispatcher thread; ``done`` is the cross-thread completion signal.
    """

    def __init__(self, job_id: int, spec, *, priority: int = 0,
                 pinned: bool = False, timeout: float | None = None,
                 tenant: str = "default",
                 max_inflight: int | None = None):
        if hasattr(spec, "as_pipeline"):
            spec = spec.as_pipeline()
        spec.validate()
        self.job_id = job_id
        self.spec = spec
        self.priority = priority
        self.pinned = pinned  # one-shot mode: nodes serve their own stage
        self.timeout = timeout
        # Multi-tenant metering (the gateway's fairness knobs): all jobs of
        # one tenant share a host-dispatched in-flight item budget — the
        # dispatch path (_answer) stops drawing for the tenant at the cap,
        # so a wide job cannot monopolise node credits.
        self.tenant = tenant
        self.max_inflight = max_inflight
        self.S = len(spec.stages)
        S = self.S
        details = spec.emit.e_details
        self._details = details
        self.emit_state = details.initial_state()
        self.emit_done = False
        # Item ids are per-stage (a stage-s result forwarded to stage s+1
        # gets a fresh id in s+1's id space), so dedup and loss accounting
        # stay local to one hop.
        self.next_id = [0] * S
        self.pending: list[collections.deque] = [collections.deque()
                                                 for _ in range(S)]
        self.inflight: list[dict[int, tuple[str, Any]]] = [{}
                                                           for _ in range(S)]
        self.done_ids: list[set[int]] = [set() for _ in range(S)]
        # Peer-routed hops (the receiving stage's ``route="peer"`` knob):
        # source stage -> {"key_fn": ...}.  On such a hop the host only
        # *ledgers* the transfer: an ITEM_ACK moves the item into
        # ``peer_inflight[s+1]``, keyed by the stage-s result id and
        # holding (target node, input object, input stage).  The input is
        # the LAST one the host actually saw for this item — on a chain of
        # consecutive peer hops the intermediate results never transit the
        # host, so a dead target's item is recomputed from that stage
        # (``input stage``), not necessarily from ``s``.
        self.peer_hops: dict[int, dict] = (
            spec.peer_routed_hops()
            if hasattr(spec, "peer_routed_hops") else {}
        )
        self.peer_inflight: list[dict[int, tuple[str, Any, int]]] = [
            {} for _ in range(S)]
        # Chained-hop acks race: consecutive peer hops are acked by
        # *different* nodes over independent sockets, so hop s+1's ack can
        # arrive before hop s's has created the ``peer_inflight[s+1]``
        # entry it must advance.  Such an early ack parks here as
        # (s, result id) -> (acking node, target node) and is applied the
        # moment the predecessor's ack lands (dropped if the item is
        # requeued first).
        self.parked_acks: dict[tuple[int, int], tuple[str, str]] = {}
        # WORK_BATCH send time per (stage, item id): the item-latency
        # histogram observes completion-minus-dispatch.
        self.dispatch_ts: dict[tuple[int, int], float] = {}
        self.r_details = spec.collector.r_details
        self.acc = self.r_details.init()
        # Shipped code, one (digest, pickled blob) per stage: pickled
        # once per job, addressed by digest for the warm-cache LRU.
        self.stage_code: list[tuple[str, bytes]] = []
        for st in spec.stages:
            blob = dumps_code(st.function)
            self.stage_code.append((hashlib.sha256(blob).hexdigest(), blob))
        # Lifecycle.
        self.done = threading.Event()
        self.error: BaseException | None = None
        self.result: Any = None
        self.deadline: float | None = None
        self.submitted_at: float | None = None
        self.first_result_at: float | None = None
        self.ended_at: float | None = None
        # Failure attribution for the retry history: which node the fatal
        # error surfaced on (if any) and a coarse cause classification
        # ("work_function" | "timeout" | "node_loss" | "internal").
        self.failed_node: str | None = None
        self.failure_kind: str | None = None
        self.items_collected = 0
        # Warm-load accounting (per job, summed over nodes).
        self.code_shipped = 0
        self.code_cached = 0
        # Per-job observability counters the telemetry gauges report; the
        # per-node splits let JobHandle.stats() attribute work and cache
        # behaviour to individual pool members.
        self.duplicates_dropped = 0
        self.forwarded = 0
        self.peer_forwarded = 0
        self.host_relay_bytes = 0
        self.items_by_node: dict[str, int] = {}
        self.cache_by_node: dict[str, dict[str, int]] = {}

    # -- farm state machine -------------------------------------------------

    def input_exhausted(self, s: int) -> bool:
        """Stage ``s`` will receive no further input items."""
        if s == 0:
            return self.emit_done
        return (self.input_exhausted(s - 1) and not self.pending[s - 1]
                and not self.inflight[s - 1]
                and not self.peer_inflight[s - 1])

    def stage_drained(self, s: int) -> bool:
        """Stage ``s`` has nothing left to compute now."""
        return (self.input_exhausted(s) and not self.pending[s]
                and not self.inflight[s] and not self.peer_inflight[s])

    def stage_done(self, s: int) -> bool:
        """Stage ``s`` is drained and nothing can come back to it: an item
        a peer hop shipped downstream is recomputed from the last input
        the host holds if its target dies, so while such a ledger entry
        holds a stage-``s`` input the stage's nodes must stay (they are
        owed UT only after it resolves)."""
        return self.stage_drained(s) and not any(
            in_s == s
            for t in range(s + 1, self.S)
            for _, _, in_s in self.peer_inflight[t].values())

    def next_item(self, s: int):
        if self.pending[s]:
            return self.pending[s].popleft()
        if s == 0 and not self.emit_done:
            obj, self.emit_state = self._details.create(self.emit_state)
            if obj is None:
                self.emit_done = True
                return None
            item = (self.next_id[0], obj)
            self.next_id[0] += 1
            return item
        return None  # upstream hasn't produced (or is exhausted)

    @property
    def active(self) -> bool:
        return not self.done.is_set()


class HostLoader:
    """Runs the host side of a node pool serving one or many jobs.

    Two construction modes share one dispatcher:

    * **one-shot** (the classic API): ``HostLoader(spec, ...)`` — the spec
      becomes a *pinned* primary job admitted immediately; ``run()``
      dispatches until it completes and returns the final result, sending
      UT to each node as its stage drains.
    * **pool** (the service): ``HostLoader(None, pool_nodes=N,
      pool_workers=W, ...)`` — no job at boot; ``serve(stop)`` dispatches
      jobs fed in via ``submit_job`` until ``stop`` is set, and nodes are
      never UT'd on drain (credits park between jobs).
    """

    def __init__(
        self,
        spec=None,
        timing: TimingCollector | None = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat: HeartbeatMonitor | None = None,
        register_timeout: float = 30.0,
        job_timeout: float | None = None,
        slowdown: dict[str, float] | None = None,
        artifacts: dict[str, bytes] | None = None,
        prefetch: int | None = None,
        flush_items: int = 8,
        flush_interval: float = 0.005,
        placement: PlacementPolicy | None = None,
        expected_nodes: Sequence[str] | None = None,
        relaunch: Callable[[str, str], bool] | None = None,
        pool_nodes: int | None = None,
        pool_workers: int = 1,
        telemetry: Telemetry | None = None,
        conn_wrapper: Callable[[FrameConnection], Any] | None = None,
    ):
        if spec is not None:
            if hasattr(spec, "as_pipeline"):
                spec = spec.as_pipeline()
            spec.validate()
            self.stages = spec.stages
            self._stage_by_node = dict(spec.node_assignments())
            total = spec.total_nodes
        else:
            if pool_nodes is None:
                raise TypeError(
                    "pool mode (spec=None) requires pool_nodes=<count>"
                )
            self.stages = []
            self._stage_by_node = {}
            total = pool_nodes
        self.spec = spec
        self.pool_workers = pool_workers
        self.total_nodes = total
        self.timing = timing or TimingCollector()
        self.host = host
        self.membership = Membership(heartbeat or HeartbeatMonitor())
        self.register_timeout = register_timeout
        self.placement = placement or PlacementPolicy()
        self.placement.validate(total)
        # Launch announcements: expected node ids become LAUNCHING records
        # at start(), which is what arms respawn tracking and late join.
        self.expected_nodes = list(expected_nodes or [])
        # Deployment-layer callback: relaunch(old_node_id, new_node_id) ->
        # bool, provided by the application so the barrier can respawn a
        # silent launch — and the reaper heal a mid-run death — without
        # knowing what a launcher is.
        self.relaunch = relaunch
        self._heals_used = 0
        self._last_tick: float | None = None  # when the reaper last ran
        self._awake_from: float | None = None  # the end of a host pause
        # Chaos hook: every accepted connection is passed through this
        # wrapper (identity when None) before its reader thread starts, so
        # a fault layer sees every frame of every node.
        self.conn_wrapper = conn_wrapper
        self.job_timeout = job_timeout
        self.slowdown = dict(slowdown or {})
        self.artifacts = dict(artifacts or {})
        self.prefetch = prefetch
        self.flush_items = flush_items
        self.flush_interval = flush_interval
        self.stats = HostStats()
        self.result: Any = None
        # Broadcast blocks: named read-only payloads published once on the
        # host; nodes stripe the initial chunk fetches across themselves
        # and then trade chunks peer-to-peer (~1 host copy total).
        self.blocks = peer_mod.BlockRegistry()

        # Telemetry: lifecycle events and slow gauges are *pushed* from the
        # dispatcher at state changes; fast-moving values the host already
        # maintains (wire counters, parked credits, HostStats) are *pulled*
        # at snapshot time through the samplers — the hot paths pay nothing.
        self.telemetry = telemetry or Telemetry()
        self.telemetry.set_sampler("nodes", self._sample_nodes)
        self.telemetry.set_sampler("cluster", self._sample_cluster)
        self.telemetry.set_sampler("timing", self.timing.summary)
        self.membership.on_transition = self._on_node_transition

        # Job table.  Written by the dispatcher (admission/completion) and
        # by __init__ (the primary job); submit_job only allocates ids.
        self._jobs: dict[int, JobState] = {}
        self._job_seq = 0
        self._job_lock = threading.Lock()
        self._primary: JobState | None = None
        if spec is not None:
            self._primary = self._new_job(spec, pinned=True)
            self._jobs[self._primary.job_id] = self._primary
        self.pool_ready = threading.Event()
        self.serve_error: BaseException | None = None

        self._events: queue.Queue = queue.Queue()
        self._early_events: list = []  # app frames arriving mid-bootstrap
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(total + 4)
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- job admission ------------------------------------------------------

    def _new_job(self, spec, *, pinned: bool, priority: int = 0,
                 timeout: float | None = None, tenant: str = "default",
                 max_inflight: int | None = None) -> JobState:
        with self._job_lock:
            self._job_seq += 1
            jid = self._job_seq
        return JobState(jid, spec, priority=priority, pinned=pinned,
                        timeout=timeout, tenant=tenant,
                        max_inflight=max_inflight)

    def submit_job(self, spec, *, priority: int = 0,
                   timeout: float | None = None, tenant: str = "default",
                   max_inflight: int | None = None) -> JobState:
        """Queue one job for the dispatcher (service mode).

        Returns its :class:`JobState` — wait on ``.done``, then read
        ``.result`` / ``.error``.  Higher ``priority`` jobs are answered
        first when nodes demand work; ties dispatch FIFO (job id order).
        ``tenant``/``max_inflight`` meter the dispatch path per tenant
        (see :class:`JobState`); the gateway sets them, direct service
        users normally leave the defaults.
        """
        job = self._new_job(spec, pinned=False, priority=priority,
                            timeout=timeout, tenant=tenant,
                            max_inflight=max_inflight)
        job.submitted_at = time.monotonic()
        self.telemetry.inc("jobs_submitted")
        self.telemetry.emit("job_submit", job=job.job_id,
                            priority=priority, tenant=tenant, stages=job.S)
        self._events.put(("submit", job))
        return job

    def expect_nodes(self, node_ids: Sequence[str]) -> None:
        """Announce launches after boot (the service's ``grow()`` path):
        membership is single-writer, so the records are created on the
        dispatcher thread.  Queued before ``launcher.launch`` is called,
        so the LAUNCHING record always precedes its REGISTER."""
        self._events.put(("expect", list(node_ids)))

    def retract_nodes(self, node_ids: Sequence[str]) -> None:
        """Withdraw launch announcements whose ``launcher.launch`` failed
        (the service's ``grow()`` error path): a LAUNCHING record with no
        process behind it would otherwise count as capacity on its way
        forever — suppressing autoscale scale-ups and keeping stages
        eligible in ``_check_liveness``."""
        self._events.put(("retract", list(node_ids)))

    def retire_node(self, node_id: str) -> None:
        """Gracefully retire one pool node (the service's ``shrink()``
        path): the dispatcher stops feeding it, sends UT — the node drains
        its queue, flushes, returns its timing record and exits — and any
        items still in flight host-side are requeued on UT ack exactly as
        a death would, minus the death.  Refused (no-op) for the last
        live node."""
        self._events.put(("retire", node_id))

    def _admit(self, job: JobState) -> None:
        self._jobs[job.job_id] = job
        if job.timeout is not None:
            job.deadline = time.monotonic() + job.timeout
        self.telemetry.emit("job_admit", job=job.job_id)
        self._publish_job(job)
        for rec in self.membership.nodes.values():
            if rec.alive:
                self._send_load(rec, job)

    def _sources(self, rec: NodeRecord) -> Iterator[tuple[JobState, int]]:
        """(job, stage) queues this node may draw from, scheduling order:
        priority first, then admission order; within a job, later stages
        first (drain the pipeline before widening it).  A job is skipped
        until this node acked its LOAD — work never races ahead of code."""
        jobs = sorted(
            (j for j in self._jobs.values() if j.active and j.error is None),
            key=lambda j: (-j.priority, j.job_id),
        )
        for job in jobs:
            if job.job_id not in rec.jobs_loaded:
                continue
            if job.pinned:
                yield job, self._stage_of(rec.node_id)
            else:
                for s in range(job.S - 1, -1, -1):
                    yield job, s

    # -- bootstrap ----------------------------------------------------------

    def start(self) -> None:
        """Open the load network (accept + ticker threads)."""
        for node_id in self.expected_nodes:
            self.membership.expect(node_id)
        for fn, name in ((self._accept_loop, "hnl-accept"),
                         (self._tick_loop, "hnl-ticker")):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            conn = FrameConnection(sock)
            if self.conn_wrapper is not None:
                conn = self.conn_wrapper(conn)
            t = threading.Thread(
                target=self._conn_reader, args=(conn, f"{addr[0]}:{addr[1]}"),
                name=f"hnl-reader-{addr[1]}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _conn_reader(self, conn: FrameConnection, addr: str) -> None:
        node_id = None
        try:
            first = conn.recv()
            if first.ftype is not FrameType.REGISTER:
                conn.close()
                return
            node_id = first.payload["node_id"]
            self._events.put(("register", node_id, addr, conn, first.payload))
            while True:
                frame = conn.recv()
                self._events.put(("frame", node_id, frame))
        except (ConnectionError, OSError, ValueError):
            if node_id is not None:
                self._events.put(("disconnect", node_id))

    def _tick_loop(self) -> None:
        interval = self.membership.monitor.interval_s / 2
        while not self._stop.wait(interval):
            self._events.put(("tick",))

    # -- entry points -------------------------------------------------------

    def run(self) -> Any:
        """One-shot: bootstrap, dispatch the primary job to completion,
        return its final result (the classic emit/cluster/collect farm)."""
        job = self._primary
        if job is None:
            raise RuntimeError(
                "pool-mode HostLoader has no primary job; use serve() + "
                "submit_job()"
            )
        with self.timing.phase("host", "load"):
            self._await_registrations()
        # Every member is known now: ship the complete peer directory (the
        # per-registration LOADs carried partial ones).
        self._broadcast_peer_dir()
        # Demand that raced the bootstrap (an early node finishing its LOAD
        # while stragglers registered) re-enters the event stream here.
        for ev in self._early_events:
            self._events.put(ev)
        self._early_events.clear()
        job.submitted_at = time.monotonic()
        self.telemetry.inc("jobs_submitted")
        self.telemetry.emit("job_submit", job=job.job_id,
                            priority=job.priority, stages=job.S)
        self._publish_job(job)
        if self.job_timeout is not None:
            job.deadline = job.submitted_at + self.job_timeout
        with self.timing.phase("host", "run"):
            self._dispatch(until_job=job)
        self._collect_wire_stats()
        self.result = job.result
        return self.result

    def serve(self, stop: threading.Event) -> None:
        """Pool mode: bootstrap, then dispatch submitted jobs until ``stop``.

        Run on a background thread by :class:`ClusterService`; bootstrap
        failures land in ``serve_error`` (with ``pool_ready`` set so the
        caller unblocks), and any job still active at shutdown is failed
        rather than left hanging.
        """
        try:
            with self.timing.phase("host", "load"):
                self._await_registrations()
        except BaseException as exc:
            self.serve_error = exc
            self.pool_ready.set()
            return
        self._broadcast_peer_dir()
        for ev in self._early_events:
            self._events.put(ev)
        self._early_events.clear()
        self.telemetry.emit("pool_ready",
                            nodes=self.membership.arrived_count())
        self.pool_ready.set()
        try:
            with self.timing.phase("host", "run"):
                self._dispatch(stop=stop)
        except BaseException as exc:  # dispatcher bug or unroutable failure
            self.serve_error = exc
        finally:
            for job in list(self._jobs.values()):
                if job.active:
                    self._fail_job(job, self.serve_error
                                   or RuntimeError("cluster service stopped"))
            self._collect_wire_stats()

    # -- the dispatcher -----------------------------------------------------

    def _dispatch(self, until_job: JobState | None = None,
                  stop: threading.Event | None = None) -> None:
        interval = self.membership.monitor.interval_s
        while True:
            if until_job is not None:
                if until_job.error is not None:
                    raise until_job.error
                if until_job.done.is_set() and self.membership.finished():
                    break
            if stop is not None and stop.is_set():
                return
            now = time.monotonic()
            for job in [j for j in self._jobs.values() if j.active]:
                # Zero-item jobs (and jobs drained by parked-credit answers)
                # complete here rather than waiting for a RESULT_BATCH.
                self._maybe_finish(job)
                if job.active and job.deadline is not None \
                        and now > job.deadline:
                    self._fail_job(job, TimeoutError(
                        f"cluster job exceeded "
                        f"{job.timeout or self.job_timeout}s "
                        f"(done={job.items_collected}, "
                        f"inflight={[len(f) for f in job.inflight]}, "
                        f"membership:\n{self.membership.describe()})"
                    ))
            try:
                event = self._events.get(timeout=interval)
            except queue.Empty:
                continue
            kind = event[0]
            if kind == "frame":
                _, node_id, frame = event
                if frame.ftype is FrameType.WORK_REQUEST:
                    self.stats.work_requests += 1
                    p = frame.payload or {}
                    self._answer(node_id, int(p.get("credits", 1)))
                elif frame.ftype is FrameType.RESULT_BATCH:
                    p = frame.payload
                    self._collect_results(
                        node_id, frame.job_id, p["results"],
                        int(p.get("credits", 0)),
                    )
                elif frame.ftype is FrameType.RESULT:
                    # Legacy single-result form (one frame per item).
                    self._collect_results(node_id, frame.job_id,
                                          [frame.payload], 0)
                elif frame.ftype is FrameType.ITEM_ACK:
                    p = frame.payload or {}
                    self._peer_acks(node_id, frame.job_id,
                                    p.get("acks") or [],
                                    int(p.get("credits", 0)))
                elif frame.ftype is FrameType.HEARTBEAT:
                    self.membership.beat(node_id)
                    rep = (frame.payload or {}).get("report")
                    if rep:
                        # Node-side phase/cache counters piggybacked on the
                        # beat (kept as the slow fallback channel).
                        self.telemetry.set_node(node_id, report=rep)
                elif frame.ftype is FrameType.REPORT:
                    # Off-beat telemetry push: gauges track completions as
                    # they happen instead of lagging one heartbeat.  NOT a
                    # liveness beat — death detection stays on the dedicated
                    # heartbeat path, so a node whose beacon died (or is
                    # chaos-stalled) is still reaped even while its data
                    # path keeps reporting.
                    rep = (frame.payload or {}).get("report")
                    if rep:
                        self.telemetry.set_node(node_id, report=rep)
                elif frame.ftype is FrameType.BLOCK_REQUEST:
                    self._serve_block(node_id, frame.payload or {})
                elif frame.ftype is FrameType.UT:
                    self._node_finished(node_id, frame.payload)
            elif kind == "loaded":
                # A LOAD send completing (bootstrap straggler or a per-job
                # ship): parked credits may be answerable now.
                self._apply_load_result(*event[1:])
                self._flush_waiting()
            elif kind == "tick":
                self._reap()
            elif kind == "disconnect":
                # The socket died; death itself is declared by the
                # heartbeat threshold (reap), keeping one detection path.
                pass
            elif kind == "register":
                # Late join: a node registering after the run started is
                # shipped LOAD immediately (the per-registration LOAD
                # path always supported this — the membership barrier
                # was what blocked it) and its first WORK_REQUEST is
                # answered with items or, if the stream already drained,
                # with UT.  Exactly-once is untouched: result-id dedup
                # never depended on when a node joined.
                _, node_id, addr, conn, payload = event
                # An *expected* arrival — an announced launch (a degraded
                # start's straggler, a bootstrap respawn, a mid-run heal)
                # registering late — is admitted even when elastic late
                # join is disabled: the policy gates strangers, not
                # capacity the host itself asked for.
                prior = self.membership.nodes.get(node_id)
                expected = (prior is not None
                            and prior.state in (LAUNCHING, REPLACED))
                if not expected and not self.placement.allow_late_join:
                    conn.close()
                    continue
                try:
                    rec = self.membership.register(
                        node_id, addr,
                        cores=int(payload.get("cores", 1)),
                        pid=int(payload.get("pid", 0)),
                        conn=conn,
                        peer_port=int(payload.get("peer_port", 0)),
                    )
                except ValueError:
                    conn.close()  # duplicate of a live member
                    continue
                self.stats.late_joins += 1
                self.telemetry.emit("late_join", node=node_id, address=addr,
                                    expected=expected)
                if self._primary is not None:
                    self._send_load(rec, self._primary)
                else:
                    self._send_load(rec, None)  # pool config first
                    for job in self._jobs.values():
                        if job.active:
                            self._send_load(rec, job)
                # The pool's routing peers must learn the newcomer (and it
                # the pool) or peer hops route around it forever.
                self._broadcast_peer_dir()
            elif kind == "blocks":
                self._broadcast_blocks()
            elif kind == "submit":
                self._admit(event[1])
            elif kind == "expect":
                # Pool growth: announce the launches so their REGISTERs
                # take the *expected*-arrival path (admitted even with
                # elastic late join disabled).
                for node_id in event[1]:
                    if node_id not in self.membership.nodes:
                        self.membership.expect(node_id)
            elif kind == "retract":
                # A grow() launch failed after its announcement: clear
                # the phantom record (the loop-end _check_liveness then
                # fails fast any job it was the last hope of).
                for node_id in event[1]:
                    self.membership.retract(node_id)
            elif kind == "retire":
                self._retire(event[1])
            self._check_liveness()

    # -- data plane ---------------------------------------------------------

    def _send_batch(self, rec: NodeRecord, job: JobState, batch: list,
                    s: int) -> bool:
        try:
            rec.conn.send(Frame(
                FrameType.WORK_BATCH,
                {"items": [{"id": i, "obj": o, "s": s} for i, o in batch]},
                APP_WIRE_CHANNEL,
                job_id=job.job_id,
            ))
        except OSError:
            # Never lose an item on a dead pipe: all of them go back to
            # the front of the queue; the node itself is reaped shortly.
            for item in reversed(batch):
                job.pending[s].appendleft(item)
            return False
        except ValueError as exc:
            # Encode errors (unencodable/oversized payload) are a *user
            # payload* problem, not a node death — requeueing would loop
            # forever, so they fail the job (one-shot run() re-raises).
            self._fail_job(job, exc)
            return False
        now = time.monotonic()
        for item_id, obj in batch:
            job.inflight[s][item_id] = (rec.node_id, obj)
            job.dispatch_ts[(s, item_id)] = now
        self.stats.work_batches += 1
        self.stats.max_batch = max(self.stats.max_batch, len(batch))
        self._publish_job(job)
        return True

    def _send_ut(self, node_id: str) -> None:
        rec = self.membership.nodes[node_id]
        try:
            rec.conn.send(Frame(FrameType.UT, None, APP_WIRE_CHANNEL))
        except (OSError, ValueError):
            pass

    def _retire(self, node_id: str) -> None:
        """Graceful pool shrink (dispatcher thread — membership stays
        single-writer).  The node is fenced first (``retiring`` stops
        ``_answer`` feeding it) so no WORK_BATCH can race past the UT;
        its in-flight items come back via the UT-ack requeue."""
        rec = self.membership.nodes.get(node_id)
        live = [r for r in self.membership.nodes.values()
                if r.alive and not r.retiring]
        if rec is None or not rec.alive or rec.retiring or len(live) <= 1:
            self.telemetry.emit("scale_down_skipped", node=node_id,
                                live=len(live))
            return
        rec.retiring = True
        rec.credits = 0
        self._send_ut(node_id)
        self.telemetry.inc("scale_down_events")
        self.telemetry.emit("scale_down", node=node_id,
                            pool=len(live) - 1)

    def _tenant_room(self, job: JobState,
                     used: dict[str, int]) -> int | None:
        """Remaining host-dispatched in-flight budget of this job's tenant
        (None = uncapped).  ``used`` memoizes per-_answer-call totals and
        accumulates the items drawn during the call."""
        if job.max_inflight is None:
            return None
        tenant = job.tenant
        if tenant not in used:
            used[tenant] = sum(
                sum(len(f) for f in j.inflight)
                for j in self._jobs.values()
                if j.active and j.tenant == tenant
            )
        return max(0, job.max_inflight - used[tenant])

    def _stage_room(self, job: JobState, s: int, rec: NodeRecord) -> int | None:
        """Per-stage prefetch cap on a *pool* node (None = uncapped): the
        per-stage ``prefetch=`` knob used to bind only on pinned one-shot
        deployments (where the node's whole window is one stage); on a
        shared pool it becomes a host-side admission cap — at most
        ``pool_workers + prefetch`` of this (job, stage)'s items in flight
        per node."""
        if job.pinned:
            return None  # resolved node-side via the LOAD window
        st = job.spec.stages[s]
        if st.prefetch is None:
            return None
        cap = self.pool_workers + max(0, int(st.prefetch))
        held = sum(1 for nid, _ in job.inflight[s].values()
                   if nid == rec.node_id)
        return max(0, cap - held)

    def _answer(self, node_id: str, credits: int) -> None:
        """Answer demand (the onrl server obligation), up to ``credits`` +
        any previously parked credits, drawn from the node's eligible
        (job, stage) queues in scheduling order — one WORK_BATCH per job
        touched.  Two admission caps can shrink a draw below the credit
        window: the tenant in-flight budget (gateway fairness) and the
        per-stage prefetch cap (pool jobs)."""
        rec = self.membership.nodes.get(node_id)
        if rec is None or not rec.alive or rec.retiring:
            return
        want = credits + rec.credits
        rec.credits = 0
        if want <= 0:
            return
        sent = 0
        tenant_used: dict[str, int] = {}
        for job, s in self._sources(rec):
            limit = want - sent
            room = self._tenant_room(job, tenant_used)
            if room is not None:
                limit = min(limit, room)
            stage_room = self._stage_room(job, s, rec)
            if stage_room is not None:
                limit = min(limit, stage_room)
            batch = []
            while len(batch) < limit:
                item = job.next_item(s)
                if item is None:
                    break
                batch.append(item)
            if not batch:
                continue
            if not self._send_batch(rec, job, batch, s):
                return  # dead pipe (items requeued) or job failed on encode
            if job.max_inflight is not None:
                tenant_used[job.tenant] += len(batch)
            sent += len(batch)
            if sent >= want:
                break
        leftover = want - sent
        if leftover:
            primary = self._primary
            if (primary is not None and primary.error is None
                    and primary.stage_done(self._stage_of(node_id))):
                # One-shot: this node's stage drained — it is owed UT.
                self._send_ut(node_id)
            else:
                rec.credits = leftover  # parked until items (re)appear

    def _flush_waiting(self) -> None:
        for rec in list(self.membership.nodes.values()):
            if rec.alive and rec.credits > 0:
                self._answer(rec.node_id, 0)

    # -- peer control plane --------------------------------------------------

    def _peer_acks(self, node_id: str, job_id: int, acks: list,
                   credits: int) -> None:
        """A stage-s node shipped results directly to stage-s+1 peers and
        acked the ids: advance the exactly-once ledger without the values.

        Each acked item moves into ``peer_inflight[s+1]`` — from
        ``inflight[s]`` when its stage-s input was host-dispatched, or
        from ``peer_inflight[s]`` when the input itself arrived over a
        peer edge (two consecutive ``route="peer"`` hops).  The ledger
        entry carries the last input the host saw and its stage, so a
        death of the target re-computes the item from that stage.
        Credits piggyback exactly as on a RESULT_BATCH (the sender
        already excluded peer-delivered inputs, which never consumed a
        window slot).
        """
        self.stats.item_acks += 1
        job = self._jobs.get(job_id)
        if job is None or job.error is not None:
            if credits:
                self._answer(node_id, credits)
            return
        for a in acks:
            s = int(a.get("s", 0))
            rid = a.get("id")
            target = a.get("to")
            if not 0 <= s < job.S - 1:
                continue  # malformed: the last stage has no peer hop
            self._apply_peer_ack(job, node_id, s, rid, target)
        self._publish_job(job)
        if credits:
            self._answer(node_id, credits)
        self._flush_waiting()
        self._maybe_finish(job)

    def _apply_peer_ack(self, job: JobState, node_id: str, s: int,
                        rid: int, target: str) -> None:
        """Advance the exactly-once ledger for one acked hop s -> s+1.

        Called for each ack on arrival, and again for a *parked* ack the
        moment its predecessor hop creates the ledger entry it advances
        (consecutive hops are acked by different nodes over independent
        sockets, so chained acks can arrive out of order — processing
        hop s+1's ack before hop s's would otherwise drop it as stale
        and leak the ledger entry, stalling termination forever)."""
        entry = job.inflight[s].pop(rid, None)
        # Chained peer hop: the stage-s input was itself delivered by
        # a peer, so the live ledger entry sits in peer_inflight[s].
        pentry = (job.peer_inflight[s].pop(rid, None)
                  if entry is None else None)
        t0 = job.dispatch_ts.pop((s, rid), None)
        if t0 is not None:
            self.telemetry.observe(
                "item_latency_ms", (time.monotonic() - t0) * 1e3)
        if rid in job.done_ids[s]:
            self.stats.duplicates_dropped += 1
            job.duplicates_dropped += 1
            return
        if entry is None and pentry is None:
            if s > 0 and (s - 1) in job.peer_hops:
                # Chained-hop ack race: this hop's ack beat the previous
                # hop's, so the entry it must advance does not exist yet.
                # Park it for the predecessor's arrival.
                job.parked_acks[(s, rid)] = (node_id, target)
                return
            # A stale ack: the host already requeued this item (its
            # first peer target died) — the requeued copy is
            # authoritative, and marking this one done would lose it.
            return
        if entry is not None:
            _, input_obj = entry
            in_s = s  # the host dispatched stage s's input itself
        else:
            _, input_obj, in_s = pentry
        trec = self.membership.nodes.get(target) if target else None
        if rid not in job.done_ids[s + 1] and (
                trec is None or not trec.alive):
            # Ack-after-death race: the copy was shipped into a node
            # the host has already reaped (so _requeue_node_items
            # never saw this ledger entry) and nothing downstream
            # delivered it — it is lost.  Recompute from the last
            # stage the host holds an input for, exactly as the
            # stranded-ledger path does; the done marks of the
            # replayed hops must lift or dedup would eat the redo.
            for t in range(in_s, s):
                job.done_ids[t].discard(rid)
            self._drop_parked_acks(job, rid)
            job.pending[in_s].append((rid, input_obj))
            self.stats.redispatched += 1
            self.stats.peer_redispatched += 1
            return
        job.done_ids[s].add(rid)
        # Result-before-ack race: the target may have computed and
        # delivered the forwarded item before this ack arrived (two
        # independent TCP streams).  Ledger it only if stage s+1 has
        # not already completed it, or it would sit in peer_inflight
        # forever and stall termination.
        if rid not in job.done_ids[s + 1]:
            job.peer_inflight[s + 1][rid] = (target, input_obj, in_s)
        self.stats.forwarded += 1
        self.stats.peer_forwarded += 1
        job.forwarded += 1
        job.peer_forwarded += 1
        job.items_by_node[node_id] = \
            job.items_by_node.get(node_id, 0) + 1
        rec = self.membership.nodes.get(node_id)
        if rec is not None:
            rec.items_done += 1
        self.timing.count_item(node_id)
        # A parked successor ack was waiting for exactly the ledger
        # entry created above: apply it now, same as if it had just
        # arrived (cascades down chains of any length).
        parked = job.parked_acks.pop((s + 1, rid), None)
        if parked is not None and rid in job.peer_inflight[s + 1]:
            p_node, p_target = parked
            self._apply_peer_ack(job, p_node, s + 1, rid, p_target)

    def _drop_parked_acks(self, job: JobState, rid: int) -> None:
        """An item is being requeued for recompute: acks parked by its
        now-abandoned downstream copies must never apply to the replay."""
        for key in [k for k in job.parked_acks if k[1] == rid]:
            del job.parked_acks[key]

    def _peer_dir(self) -> dict[str, tuple[str, int]]:
        """node_id -> (ip, peer data-plane port) for every routable member
        (a node that reported no peer port is simply unreachable for peer
        traffic and omitted — its results fall back through the host)."""
        out: dict[str, tuple[str, int]] = {}
        for rec in self.membership.nodes.values():
            if not rec.alive or not rec.peer_port:
                continue
            # The observed address is "ip:port"; split from the RIGHT and
            # strip any brackets so an IPv6 ip ("::1:54321", "[::1]:54321")
            # survives — a left split would truncate it to "" and silently
            # demote every peer edge to host relay.
            ip = "127.0.0.1"
            if rec.address:
                ip = rec.address.rsplit(":", 1)[0].strip("[]") or ip
            out[rec.node_id] = (ip, rec.peer_port)
        return out

    def _peer_routes(self, job: JobState | None) -> dict:
        """Host-assigned routing table for one job's peer hops: for each
        source stage the ordered target list (stage-s+1 capacity), the
        partition mode, and the serialized key function for keyed
        shuffles.  Pool jobs route over every routable member (any node
        serves any stage); pinned one-shot jobs route to the nodes
        assigned to the receiving stage."""
        if job is None or not job.peer_hops:
            return {}
        directory = self._peer_dir()
        routes: dict[str, dict] = {}
        for s, cfg in sorted(job.peer_hops.items()):
            if job.pinned:
                targets = [nid for nid, st in job.spec.node_assignments()
                           if st == s + 1 and nid in directory]
            else:
                targets = [nid for nid in directory]
            key_fn = cfg.get("key_fn")
            routes[str(s)] = {
                "targets": targets,
                "mode": "keyed" if key_fn is not None else "rr",
                "key_fn": (dumps_code(key_fn)
                           if key_fn is not None else None),
            }
        return routes

    def _send_peer_refresh(self, rec: NodeRecord) -> None:
        """Ship the peer directory as known now to one node, with the
        routing table of every active job that has peer hops, built from
        that directory (a LOAD with no ``workers`` key is a refresh, not a
        deployment)."""
        directory = self._peer_dir()
        frames = [Frame(FrameType.LOAD,
                        {"peer": {"dir": directory,
                                  "routes": self._peer_routes(job)}},
                        LOAD_WIRE_CHANNEL, job_id=job.job_id)
                  for job in self._jobs.values()
                  if job.active and job.peer_hops]
        if not frames:
            frames = [Frame(FrameType.LOAD,
                            {"peer": {"dir": directory, "routes": {}}},
                            LOAD_WIRE_CHANNEL)]
        try:
            for frame in frames:
                rec.conn.send(frame)
        except (OSError, ValueError):
            pass

    def _broadcast_peer_dir(self) -> None:
        """Ship the complete peer directory, and the routing tables built
        from it, to every live node.  Called after the membership barrier
        and on every late join/heal: a per-registration LOAD carried only
        the members known when it was built, so a sender that registered
        before its receiving stage's nodes would otherwise relay every hop
        through the host.  A node whose own LOAD is still in flight gets
        the same refresh again once that LOAD is sent
        (``_apply_load_result``), so its stale table never has the last
        word."""
        if not self._peer_dir():
            return
        for rec in self.membership.nodes.values():
            if rec.alive and rec.conn is not None:
                self._send_peer_refresh(rec)

    def _broadcast_blocks(self) -> None:
        """Push the block manifest to every live node so striped fetches
        start now rather than on the next job LOAD."""
        manifest = self.blocks.manifest()
        if not manifest:
            return
        payload = {"blocks": manifest, "peer": {"dir": self._peer_dir(),
                                                "routes": {}}}
        for rec in self.membership.nodes.values():
            if not rec.alive or rec.conn is None:
                continue
            try:
                rec.conn.send(Frame(FrameType.LOAD, payload,
                                    LOAD_WIRE_CHANNEL))
            except (OSError, ValueError):
                pass

    def _serve_block(self, node_id: str, p: dict) -> None:
        """Answer one striped BLOCK_REQUEST with its chunk (data=None on a
        miss — the node retries from peers or re-requests later)."""
        rec = self.membership.nodes.get(node_id)
        if rec is None or rec.conn is None:
            return
        name = p.get("name")
        idx = int(p.get("chunk", 0))
        data = self.blocks.get_chunk(name, idx)
        if data is not None:
            self.telemetry.observe("block_chunk_bytes", len(data))
        try:
            rec.conn.send(Frame(
                FrameType.BLOCK_CHUNK,
                {"name": name, "chunk": idx, "data": data},
                LOAD_WIRE_CHANNEL,
            ))
        except (OSError, ValueError):
            pass

    def publish_block(self, name: str, data: bytes) -> str:
        """Publish a named read-only payload for the whole pool; returns
        its digest.  Registration is synchronous (any thread); the
        manifest broadcast rides the event queue so socket writes stay on
        the dispatcher."""
        digest = self.blocks.publish(name, data)
        self._events.put(("blocks",))
        return digest

    def _items_collected(self) -> int:
        if self._primary is not None:
            return self._primary.items_collected
        return sum(j.items_collected for j in self._jobs.values())

    def _reap(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        last, self._last_tick = self._last_tick, now
        # The reaper runs every half beat.  A tick a whole beat late means
        # the host itself was paused (descheduled on a loaded machine): the
        # beats that reached its sockets meanwhile are still unread, and
        # ticks queued during the pause may come back to back.  So reaping
        # waits until the host has been awake for one beat interval, in
        # which every live node beats.  A late tick does not restart a wait
        # that is running, so ticks that keep coming late reap every other
        # time and a node that did die is still declared dead.
        interval = self.membership.monitor.interval_s
        if self._awake_from is None and last is not None and now - last > interval:
            self._awake_from = now
        if self._awake_from is not None:
            if now - self._awake_from < interval:
                return
            self._awake_from = None
        newly_dead = self.membership.reap(now, at_item=self._items_collected())
        for rec in newly_dead:
            self._on_node_death(rec)
        if newly_dead:
            self._flush_waiting()

    def _on_node_death(self, rec: NodeRecord) -> None:
        """One detected mid-run death: surface it on the bus with its
        detection metadata, requeue the node's in-flight items, and — if
        the policy grants a heal — relaunch a replacement."""
        self.stats.deaths_detected += 1
        ev = rec.last_failure
        self.telemetry.inc("failures_detected")
        self.telemetry.emit(
            "failure",
            failure=ev.kind if ev else "node_loss",
            node=rec.node_id,
            node_index=rec.index,
            detect_latency_ms=(round(ev.detect_latency_s * 1e3, 3)
                               if ev else None),
            at_item=ev.step if ev else None,
        )
        self._requeue_node_items(rec.node_id)
        self._heal(rec)

    def _requeue_node_items(self, node_id: str) -> bool:
        """Requeue every item a departed node can no longer deliver.

        Host-dispatched in-flight items re-enter their own stage's queue.
        Peer-shipped items stranded on the node are *recomputed* upstream:
        the ledger holds the last input the host saw (on a chain of
        consecutive peer hops that can be several stages back), so the
        replayed hops' result ids are un-done and the item re-dispatched
        at the input's stage under the same id — the dedup sets absorb
        any racing late delivery from the first computation.
        """
        requeued = False
        for job in self._jobs.values():
            if not job.active:
                continue
            for s in range(job.S):
                lost = [iid for iid, (nid, _) in job.inflight[s].items()
                        if nid == node_id]
                for iid in lost:
                    _, obj = job.inflight[s].pop(iid)
                    self._drop_parked_acks(job, iid)
                    job.pending[s].append((iid, obj))
                    self.stats.redispatched += 1
                    requeued = True
                stranded = [rid for rid, (nid, _, _)
                            in job.peer_inflight[s].items()
                            if nid == node_id]
                for rid in stranded:
                    _, obj, in_s = job.peer_inflight[s].pop(rid)
                    for t in range(in_s, s):
                        job.done_ids[t].discard(rid)
                    self._drop_parked_acks(job, rid)
                    job.pending[in_s].append((rid, obj))
                    self.stats.redispatched += 1
                    self.stats.peer_redispatched += 1
                    requeued = True
        return requeued

    def _heal(self, rec: NodeRecord) -> bool:
        """Mid-run pool healing: answer a death with a fresh launch through
        the same ``relaunch`` path the bootstrap respawn uses.

        The replacement is announced (LAUNCHING) and registers through the
        dispatcher like any expected straggler — LOAD (warm code cache
        re-shipped), credits armed by its first WORK_REQUEST — completing
        the dead → launching → registered transition chain.  Budgeted by
        ``PlacementPolicy.max_heals`` (0 = historical shrink-to-survivors).
        """
        if (self.relaunch is None or self._stop.is_set()
                or self._heals_used >= self.placement.max_heals):
            return False
        attempts = rec.attempts + 1
        new_id = f"{rec.node_id}r{attempts}"
        while new_id in self.membership.nodes:  # bootstrap respawn took it
            attempts += 1
            new_id = f"{rec.node_id}r{attempts}"
        try:
            ok = self.relaunch(rec.node_id, new_id)
        except Exception:
            ok = False
        if not ok:
            self.telemetry.emit("heal_failed", node=rec.node_id,
                                replacement=new_id)
            return False
        nrec = self.membership.expect(new_id)
        nrec.attempts = attempts
        self._heals_used += 1
        self.stats.heals += 1
        self.stats.respawns += 1
        self.telemetry.inc("heals")
        self.telemetry.emit("heal", node=rec.node_id, replacement=new_id,
                            heals_used=self._heals_used,
                            heals_budget=self.placement.max_heals)
        return True

    def _collect_results(self, node_id: str, job_id: int, results: list,
                         credits: int) -> None:
        self.stats.result_batches += 1
        job = self._jobs.get(job_id)
        if job is None or job.error is not None:
            # A zombie batch for a torn-down/failed job: the results are
            # moot but the credits still replenish the node's window.
            if credits:
                self._answer(node_id, credits)
            return
        self.telemetry.observe("result_batch_items", len(results))
        for p in results:
            s = int(p.get("s", 0))
            if "error" in p:
                self._fail_job(job, WorkFunctionError(
                    f"work function raised on {node_id} for item "
                    f"{p['id']}: {p['error']}\n"
                    f"{p.get('traceback', '')}"
                ), node=node_id)
                break
            # Always clear inflight — a redispatched item can complete
            # twice (zombie result + survivor result) and both entries
            # must go or termination stalls.  Peer-delivered items live in
            # the peer ledger instead.
            job.inflight[s].pop(p["id"], None)
            job.peer_inflight[s].pop(p["id"], None)
            t0 = job.dispatch_ts.pop((s, p["id"]), None)
            if t0 is not None:
                self.telemetry.observe(
                    "item_latency_ms", (time.monotonic() - t0) * 1e3)
            if p["id"] in job.done_ids[s]:
                self.stats.duplicates_dropped += 1
                job.duplicates_dropped += 1
            else:
                job.done_ids[s].add(p["id"])
                if s + 1 < job.S:
                    # Any payload passing through here rode the host for
                    # its stage hop — on a peer hop that only happens in
                    # degraded relay (every peer target unreachable), on a
                    # host-routed hop it is the normal path.  Either way
                    # the bytes are the traffic the peer plane exists to
                    # absorb, so both count toward host_relay_bytes.
                    _, bufs = encode_payload(p["value"])
                    nbytes = _buffers_len(bufs)
                    job.host_relay_bytes += nbytes
                    self.stats.host_relay_bytes += nbytes
                    if s in job.peer_hops:
                        # Keep the result-id space so host-relayed and
                        # peer-shipped copies of one item dedup against each
                        # other at stage s+1.
                        job.pending[s + 1].append((p["id"], p["value"]))
                    else:
                        # The hop rendezvous: this result *is* stage s+1's
                        # next work item (dedup above makes it exactly
                        # once).
                        job.pending[s + 1].append((job.next_id[s + 1],
                                                   p["value"]))
                        job.next_id[s + 1] += 1
                    self.stats.forwarded += 1
                    job.forwarded += 1
                else:
                    job.acc = job.r_details.collect(job.acc, p["value"])
                    job.items_collected += 1
                    if job.first_result_at is None:
                        job.first_result_at = time.monotonic()
                    self.stats.items_total += 1
                job.items_by_node[node_id] = \
                    job.items_by_node.get(node_id, 0) + 1
                rec = self.membership.nodes[node_id]
                rec.items_done += 1
                self.timing.count_item(node_id)
        self._publish_job(job)
        if credits:
            self._answer(node_id, credits)
        # Forwarded items may satisfy parked downstream demand, and a
        # stage draining may owe its nodes UT: both are answered here.
        self._flush_waiting()
        self._maybe_finish(job)

    # -- job lifecycle ------------------------------------------------------

    def _maybe_finish(self, job: JobState) -> None:
        if not job.active or job.error is not None:
            return
        if not job.stage_done(job.S - 1):
            return
        job.result = job.r_details.finalise(job.acc)
        job.ended_at = time.monotonic()
        self.telemetry.inc("jobs_completed")
        elapsed_ms = None
        if job.submitted_at is not None:
            elapsed_ms = round((job.ended_at - job.submitted_at) * 1e3, 3)
        self.telemetry.emit("job_done", job=job.job_id,
                            items=job.items_collected, elapsed_ms=elapsed_ms)
        self._publish_job(job)
        # Publish the terminal gauges *before* releasing waiters: a caller
        # snapshotting /metrics the instant result() returns must already
        # see done=True.
        job.done.set()
        if not job.pinned:
            self._send_job_close(job)

    def _fail_job(self, job: JobState, exc: BaseException, *,
                  node: str | None = None, kind: str | None = None) -> None:
        if job.done.is_set():
            return
        job.error = exc
        job.ended_at = time.monotonic()
        if node is not None:
            job.failed_node = node
        if kind is None:
            if isinstance(exc, WorkFunctionError):
                kind = "work_function"
            elif isinstance(exc, TimeoutError):
                kind = "timeout"
            else:
                kind = "internal"
        job.failure_kind = kind
        self.telemetry.inc("jobs_failed")
        self.telemetry.emit("job_failed", job=job.job_id, error=str(exc),
                            cause=kind, node=job.failed_node)
        self._publish_job(job)
        # As in _maybe_finish: gauges first, then release waiters.
        job.done.set()
        # Aborted/timed-out jobs must tear down on *every* error path —
        # pinned included — or nodes keep stale bindings (and keep
        # computing a window of items for a job nobody will collect).
        self._send_job_close(job)

    def _send_job_close(self, job: JobState) -> None:
        """Per-job teardown: nodes drop the job's bindings (warm code cache
        entries survive) and their credits stay pooled for the next job.

        Sent to *every* live node, not just those that acked the job's
        LOAD: a node whose LOAD is still in flight when the job dies would
        otherwise bind a dead job and hold it forever (the close for an
        unknown job is a no-op node-side, so over-sending is harmless).
        """
        for rec in self.membership.nodes.values():
            rec.jobs_loaded.discard(job.job_id)
            if not rec.alive or rec.conn is None:
                continue
            try:
                rec.conn.send(Frame(FrameType.JOB_CLOSE,
                                    {"job_id": job.job_id},
                                    APP_WIRE_CHANNEL, job_id=job.job_id))
            except (OSError, ValueError):
                pass

    def _check_liveness(self) -> None:
        """A job with obligations left but no eligible live nodes can never
        finish — fail it fast instead of idling to its deadline.  LAUNCHING
        members keep a stage eligible: a degraded start's straggler (or a
        respawned launch) may still register and carry the stage — but only
        within ``register_timeout`` of its announcement; a launch silent
        longer than the boot barrier would wait is a phantom (the process
        died pre-REGISTER) and must not hold jobs open forever."""
        now = time.monotonic()
        for job in [j for j in self._jobs.values() if j.active]:
            failed = False
            for s in range(job.S):
                if job.stage_drained(s):
                    continue
                if job.pinned:
                    members = [rec for rec in self.membership.nodes.values()
                               if self._stage_of(rec.node_id) == s]
                else:
                    members = list(self.membership.nodes.values())
                if any(rec.alive
                       or (rec.state == LAUNCHING
                           and now - rec.state_changed_at
                               < self.register_timeout)
                       for rec in members):
                    continue
                self._fail_job(job, RuntimeError(
                    f"all node-loaders of stage {job.spec.stages[s].name!r} "
                    f"died with work outstanding ({len(job.inflight[s])} "
                    f"in flight, {len(job.pending[s])} queued; no launch "
                    "pending)"
                ))
                failed = True
                break
            if failed:
                continue

    def _stage_of(self, node_id: str) -> int:
        """Stage index of a one-shot node (respawn replacements via their
        base id; unknown elastic joiners default to stage 0)."""
        s = self._stage_by_node.get(node_id)
        if s is not None:
            return s
        base = node_id.split("r", 1)[0]
        return self._stage_by_node.get(base, 0)

    # -- bootstrap helpers --------------------------------------------------

    def _await_registrations(self) -> None:
        """The membership barrier, driven by the placement policy.

        Strict mode (the default policy) reproduces the seed behaviour:
        block until all ``nclusters`` launches registered or raise at
        ``register_timeout``.  The policy relaxes it three ways:

        * *respawn-on-silent-node* — an announced launch quiet past its
          ``respawn_after`` window is retired (REPLACED) and relaunched
          elsewhere through the deployment layer's ``relaunch`` callback,
          up to ``max_respawns`` times cluster-wide;
        * *degraded start* — at the timeout the job is admitted with the
          survivors if at least ``min_nodes`` arrived, instead of raising;
          the missing stragglers stay LAUNCHING and may still late-join;
        * a launch arriving *during* the barrier under a REPLACED id is
          re-admitted (membership handles the transition) — first
          registration wins, extra capacity is never turned away.
        """
        pol = self.placement
        expected = self.total_nodes
        min_nodes = expected if pol.min_nodes is None else pol.min_nodes
        respawn_after = pol.respawn_after
        if respawn_after is None:
            respawn_after = self.register_timeout / (pol.max_respawns + 1)
        respawns_left = pol.max_respawns
        t0 = time.monotonic()
        deadline = t0 + self.register_timeout
        # The silence clock starts *now*: launch announcements were stamped
        # at start(), before the launcher's prepare() (possibly a slow code
        # sync to many machines) and the sequential launch() calls — judging
        # silence from that stamp would respawn healthy just-launched nodes.
        for rec in self.membership.launching_nodes():
            rec.launched_at = t0
        while self.membership.arrived_count() < expected:
            now = time.monotonic()
            next_respawn_due: float | None = None
            if self.relaunch is not None and respawns_left > 0:
                for rec in self.membership.launching_nodes():
                    if respawns_left <= 0:
                        break
                    due = rec.launched_at + respawn_after
                    if now >= due:
                        if self._respawn(rec):
                            respawns_left -= 1
                    elif next_respawn_due is None or due < next_respawn_due:
                        next_respawn_due = due
            if now >= deadline:
                arrived = self.membership.arrived_count()
                if arrived >= min_nodes:
                    # Degraded start: the survivors carry the job; the
                    # demand-driven protocol needs no topology change.
                    self.stats.degraded_start = arrived < expected
                    if self.stats.degraded_start:
                        self.telemetry.emit("degraded_start",
                                            arrived=arrived,
                                            expected=expected)
                    return
                raise TimeoutError(
                    f"only {arrived}/{expected} node-loaders registered "
                    f"within {self.register_timeout}s (min_nodes="
                    f"{min_nodes}, respawns used="
                    f"{pol.max_respawns - respawns_left})"
                )
            timeout = deadline - now
            if next_respawn_due is not None:
                timeout = min(timeout, next_respawn_due - now)
            try:
                event = self._events.get(timeout=max(0.01, timeout))
            except queue.Empty:
                continue
            if event[0] == "loaded":
                self._apply_load_result(*event[1:])
                continue
            if event[0] == "frame":
                # Early heartbeats (nodes beat from REGISTER onwards) must
                # count, or a node registering early could be declared dead
                # while the stragglers are still connecting.  Other early
                # frames (a loaded node's first WORK_REQUEST) are replayed
                # into the dispatcher once bootstrap completes.
                _, node_id, frame = event
                if frame.ftype in (FrameType.HEARTBEAT, FrameType.REPORT):
                    if frame.ftype is FrameType.HEARTBEAT:
                        self.membership.beat(node_id)
                    rep = (frame.payload or {}).get("report")
                    if rep:
                        self.telemetry.set_node(node_id, report=rep)
                elif frame.ftype is FrameType.BLOCK_REQUEST:
                    # A fast-booting node striping pre-published blocks
                    # while stragglers still register.
                    self._serve_block(node_id, frame.payload or {})
                else:
                    self._early_events.append(event)
                continue
            if event[0] == "submit":
                # A service job submitted before the pool finished booting:
                # admission happens in the dispatcher, after the barrier.
                self._early_events.append(event)
                continue
            if event[0] != "register":
                continue  # pre-bootstrap noise
            _, node_id, addr, conn, payload = event
            try:
                rec = self.membership.register(
                    node_id, addr,
                    cores=int(payload.get("cores", 1)),
                    pid=int(payload.get("pid", 0)),
                    conn=conn,
                    peer_port=int(payload.get("peer_port", 0)),
                )
            except ValueError:
                conn.close()  # duplicate node_id: reject it, keep waiting
                continue
            # Overlapped load: ship code the moment a node shows up, so its
            # deserialization/imports run while stragglers still register.
            self._send_load(rec, self._primary)

    def _respawn(self, rec: NodeRecord) -> bool:
        """Retire a silent launch and start a replacement elsewhere."""
        new_id = f"{rec.node_id}r{rec.attempts + 1}"
        try:
            ok = self.relaunch(rec.node_id, new_id)
        except Exception:
            ok = False
        if not ok:
            # Could not place a replacement: re-arm the silence window so
            # the original keeps its chance instead of burning the budget
            # in a tight loop.
            rec.launched_at = time.monotonic()
            return False
        self.membership.replace(rec.node_id)
        nrec = self.membership.expect(new_id)
        nrec.attempts = rec.attempts + 1
        self.stats.respawns += 1
        self.telemetry.emit("respawn", node=rec.node_id, replacement=new_id)
        return True

    # -- code shipping ------------------------------------------------------

    def _load_entries(self, rec: NodeRecord, job: JobState) -> list[dict]:
        """Per-stage LOAD entries for one node, consulting (and updating)
        the host's mirror of its code-cache LRU: a digest the node still
        holds ships ``function=None`` (the warm-resubmit fast path)."""
        if job.pinned:
            s_list = [self._stage_of(rec.node_id)]
        else:
            s_list = list(range(job.S))
        entries = []
        cache = job.cache_by_node.setdefault(rec.node_id,
                                             {"hits": 0, "misses": 0})
        for s in s_list:
            digest, blob = job.stage_code[s]
            if digest in rec.code_digests:
                rec.code_digests.move_to_end(digest)
                fn_blob = None
                job.code_cached += 1
                cache["hits"] += 1
            else:
                rec.code_digests[digest] = None
                while len(rec.code_digests) > CODE_CACHE_SLOTS:
                    rec.code_digests.popitem(last=False)
                fn_blob = blob
                job.code_shipped += 1
                cache["misses"] += 1
            entry = {"s": s, "stage": job.spec.stages[s].name,
                     "digest": digest, "function": fn_blob}
            # Per-stage data-plane knobs for *pool* jobs ride the job's
            # LOAD entries instead of the host-global pool config: the
            # node tightens its flush cadence per job (min over bound
            # stages), the host caps per-stage in-flight items per node
            # (_stage_room) — pinned one-shot deployments keep resolving
            # them into the node-global window/flush as before.
            if not job.pinned:
                st = job.spec.stages[s]
                if st.flush_ms is not None:
                    entry["flush_ms"] = float(st.flush_ms)
                if st.prefetch is not None:
                    entry["prefetch"] = int(st.prefetch)
            entries.append(entry)
        return entries

    def _send_load(self, rec: NodeRecord, job: JobState | None) -> None:
        """Ship a deployment (pool config and/or one job's stages) to one
        node from a dedicated sender thread.

        A node booting heavy deps drains its socket only once its preloader
        finishes; a large LOAD (MBs of artifacts) would therefore block a
        synchronous send past the kernel buffer — and block the dispatcher
        with it, re-serializing the very bootstrap the overlap parallelizes.
        The payload is built *here* (dispatcher thread — it touches job and
        LRU state); the sender thread only sends, reporting back through
        the event queue (``("loaded", node_id, ok, job_id)``) so membership
        stays single-writer.
        """
        if job is not None:
            entries = self._load_entries(rec, job)
        else:
            entries = []
        # Per-stage data-plane knobs resolve host-side: a pinned node's
        # single stage may override the cluster-wide prefetch/flush values.
        prefetch, flush_interval = self.prefetch, self.flush_interval
        if job is not None and job.pinned:
            st = job.spec.stages[self._stage_of(rec.node_id)]
            workers = st.workers_per_node
            if st.prefetch is not None:
                prefetch = st.prefetch
            if st.flush_ms is not None:
                flush_interval = st.flush_ms / 1000.0
        else:
            workers = self.pool_workers
        job_id = 0 if job is None else job.job_id
        payload = {
            "node_id": rec.node_id,
            "workers": workers,
            "heartbeat_interval": self.membership.monitor.interval_s,
            "slowdown": float(self.slowdown.get(rec.node_id, 0.0)),
            "artifacts": self.artifacts,
            "prefetch": prefetch,
            "flush_items": self.flush_items,
            "flush_interval": flush_interval,
            "stages": entries,
            # Peer data plane: the directory known so far (completed by the
            # post-barrier broadcast) and, per peer-routed hop, this job's
            # routing table.  Published broadcast blocks ride along so the
            # node starts its striped fetch during the load window.
            "peer": {"dir": self._peer_dir(),
                     "routes": self._peer_routes(job)},
        }
        manifest = self.blocks.manifest()
        if manifest:
            payload["blocks"] = manifest

        def sender() -> None:
            try:
                rec.conn.send(Frame(FrameType.LOAD, payload,
                                    LOAD_WIRE_CHANNEL, job_id=job_id))
            except Exception:
                # Dead pipe or an unserializable deployment: either way the
                # node can never load — report it so it is marked dead
                # (unloadable everywhere -> "all node-loaders died") rather
                # than leaving the job to idle until job_timeout.
                self._events.put(("loaded", rec.node_id, False, job_id))
                return
            self._events.put(("loaded", rec.node_id, True, job_id))

        t = threading.Thread(target=sender, name=f"hnl-load-{rec.node_id}",
                             daemon=True)
        t.start()
        self._threads.append(t)

    def _apply_load_result(self, node_id: str, ok: bool,
                           job_id: int = 0) -> None:
        rec = self.membership.nodes.get(node_id)
        if ok:
            if rec is not None and rec.alive:  # never resurrect a reaped node
                self.membership.mark_loaded(node_id)
                job = self._jobs.get(job_id)
                if job is not None and not job.active:
                    # The job ended while its LOAD was in flight: close it
                    # on this node immediately instead of binding a corpse.
                    try:
                        rec.conn.send(Frame(FrameType.JOB_CLOSE,
                                            {"job_id": job_id},
                                            APP_WIRE_CHANNEL, job_id=job_id))
                    except (OSError, ValueError):
                        pass
                else:
                    rec.jobs_loaded.add(job_id)
                    if job is not None and job.peer_hops:
                        self._send_peer_refresh(rec)
            return
        # Died between REGISTER and LOAD: a bootstrap-time node loss,
        # handled like any other — requeue + surface + (policy permitting)
        # heal, exactly as a heartbeat-detected death.
        if self.membership.mark_dead(node_id) is not None:
            self._on_node_death(rec)
            self._flush_waiting()

    def _node_finished(self, node_id: str, payload: Any) -> None:
        timing = payload or {}
        self.membership.mark_done(node_id, timing)
        self.timing.add(node_id, "boot", float(timing.get("boot_ms", 0.0)))
        self.timing.add(node_id, "load", float(timing.get("load_ms", 0.0)))
        self.timing.add(node_id, "run", float(timing.get("run_ms", 0.0)))
        self.telemetry.emit("node_done", node=node_id,
                            items=int(timing.get("items", 0)))
        # A node retiring with jobs still active (it hit a decode error, or
        # its host-side channel died under it) will never deliver results
        # for its in-flight items — requeue them exactly as a death does,
        # or the job stalls to its deadline.
        if self._requeue_node_items(node_id):
            self._flush_waiting()

    def _collect_wire_stats(self) -> None:
        """Fold per-connection traffic counters + protocol counters into the
        timing collector (printed by ``TimingCollector.report``)."""
        agg = {"bytes_sent": 0, "bytes_recv": 0,
               "frames_sent": 0, "frames_recv": 0}
        for rec in self.membership.nodes.values():
            if rec.conn is None:
                continue
            for key, val in rec.conn.counters.as_dict().items():
                agg[key] += val
        agg["work_requests"] = self.stats.work_requests
        agg["work_batches"] = self.stats.work_batches
        agg["result_batches"] = self.stats.result_batches
        agg["max_batch"] = self.stats.max_batch
        # One round-trip = one host-bound demand frame (explicit request or
        # piggybacked result batch) plus its answer.
        agg["round_trips"] = self.stats.work_requests + self.stats.result_batches
        self.timing.add_wire(**agg)

    # -- telemetry ----------------------------------------------------------

    def _on_node_transition(self, rec: NodeRecord, old: str) -> None:
        """Membership hook (dispatcher thread): every node state change
        becomes one bus event plus a node gauge update."""
        self.telemetry.emit("membership", node=rec.node_id, state=rec.state,
                            prev=old)
        self.telemetry.set_node(rec.node_id, state=rec.state)

    def _publish_job(self, job: JobState) -> None:
        """Push one job's farm gauges (dispatcher thread, per state change /
        batch — never per item)."""
        self.telemetry.set_job(
            job.job_id,
            priority=job.priority,
            stages=job.S,
            pending=[len(q) for q in job.pending],
            inflight=[len(f) for f in job.inflight],
            items_collected=job.items_collected,
            duplicates_dropped=job.duplicates_dropped,
            forwarded=job.forwarded,
            peer_forwarded=job.peer_forwarded,
            host_relay_bytes=job.host_relay_bytes,
            code_shipped=job.code_shipped,
            code_cached=job.code_cached,
            # ended_at, not the event: terminal publishes happen just
            # before done.set() releases waiters (see _maybe_finish).
            done=job.ended_at is not None,
            error=None if job.error is None else str(job.error),
        )

    def _sample_nodes(self) -> dict:
        """Pull-side node fields, read on the snapshot caller's thread.

        The dispatcher mutates ``membership.nodes`` (and each record)
        concurrently; rather than lock the protocol hot path, dict
        iteration simply retries on RuntimeError — the values are
        monotonic-enough counters where a midway-consistent read is fine
        for reporting.
        """
        for _ in range(8):
            try:
                out = {}
                for rec in list(self.membership.nodes.values()):
                    fields = {
                        "state": rec.state,
                        "address": rec.address,
                        "items": rec.items_done,
                        "credits": rec.credits,
                        "beats": rec.beats,
                        "attempts": rec.attempts,
                        "state_changed_at": round(rec.state_changed_at, 6),
                        "transitions": [
                            {"state": s, "at": round(at, 6)}
                            for s, at in list(rec.transitions)[-8:]
                        ],
                    }
                    if rec.conn is not None:
                        fields["wire"] = rec.conn.counters.as_dict()
                    out[rec.node_id] = fields
                return out
            except RuntimeError:
                continue
        return {}

    def _sample_cluster(self) -> dict:
        """Pull-side cluster counters: the HostStats the dispatcher already
        maintains, plus liveness/credit aggregates."""
        out = dict(vars(self.stats))
        for _ in range(8):
            try:
                nodes = list(self.membership.nodes.values())
                jobs = list(self._jobs.values())
                break
            except RuntimeError:
                continue
        else:
            return out
        out["nodes_total"] = len(nodes)
        out["nodes_alive"] = sum(1 for r in nodes if r.alive)
        out["credits_parked"] = sum(r.credits for r in nodes if r.alive)
        out["jobs_active"] = sum(1 for j in jobs if j.active)
        out["blocks_published"] = len(self.blocks.manifest())
        out["block_chunks_served"] = self.blocks.chunks_served
        out["block_bytes_served"] = self.blocks.chunk_bytes_served
        return out

    # -- teardown -----------------------------------------------------------

    def _member_snapshot(self) -> list[NodeRecord]:
        """Cross-thread membership snapshot for teardown paths: the
        dispatcher may still be inserting records (a queued ``expect``)
        while the closing thread walks them, and dict iteration during a
        resize raises RuntimeError."""
        for _ in range(8):
            try:
                return list(self.membership.nodes.values())
            except RuntimeError:
                continue
        return []

    def shutdown_nodes(self) -> None:
        """Send UT to every live node (pool teardown — they exit cleanly)."""
        for rec in self._member_snapshot():
            if rec.alive and rec.conn is not None:
                try:
                    rec.conn.send(Frame(FrameType.UT, None, APP_WIRE_CHANNEL))
                except (OSError, ValueError):
                    pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for rec in self._member_snapshot():
            if rec.conn is not None:
                rec.conn.close()
        self.telemetry.close()  # flush the trace; the bus itself stays readable
