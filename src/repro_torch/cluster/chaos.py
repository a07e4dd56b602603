"""Chaos-injection harness for the *real* multi-process transport.

The SPMD executor already injects simulated failures (``runtime.failures
.FailurePlan``); this module attacks the actual wire protocol — sockets,
frames, heartbeats, node processes — so the detect → requeue → heal →
retry machinery is exercised continuously instead of assumed.  The paper
claims the generated architecture is "free from deadlock and livelock" on
failure-prone workstations; a :class:`FaultPlan` is how we keep earning
that claim on every run.

Three layers:

* :class:`Fault` / :class:`FaultPlan` — a declarative list of timed
  (``at_s``) or progress-conditioned (``after_items``) faults.  Kinds:

  - ``kill_node`` — hard-kill one node mid-job through the deployment
    layer (real death: heartbeats stop, the host reaps and heals);
  - ``drop`` — discard matching frames (defaults to HEARTBEAT: data
    frames on a live TCP stream are delivered exactly once by the
    transport, so dropping them is *unrecoverable by design* — recovery
    always flows through death detection);
  - ``delay`` / ``straggler`` — hold each matching inbound frame for
    ``delay_s`` (a slow workstation, seen from the host's side);
  - ``duplicate`` — deliver matching inbound frames twice (exercises the
    result-id dedup that exactly-once collection rests on);
  - ``stall_heartbeat`` — drop the node's beats only: the host declares a
    perfectly healthy node dead and its late results arrive as zombie
    duplicates;
  - ``partition`` — drop *everything* both ways for ``duration_s``
    (choose it >= the heartbeat deadline so the death path can recover);
  - ``corrupt`` — rewrite the codec byte of an outbound frame so the
    node's ``decode_payload`` raises (the decode-error death path).

* :class:`WireFaults` + :class:`FaultyConnection` — an injectable wrapper
  over :class:`~repro_torch.cluster.wire.FrameConnection` (duck-compatible with
  it and with :class:`~repro_torch.cluster.netchannels.ChannelMux`'s ``conn``)
  that applies the active wire rules on the host's per-node connections.
  Drop/delay/duplicate act on the *recv*
  path (each node has its own reader thread, so a sleep there slows only
  that node); corrupt acts on *send* (the bytes must be damaged before
  the node decodes them).

* :class:`ChaosController` — owns the plan: a poll thread fires each
  fault at its trigger, turning it into a node kill (via the injected
  ``kill`` callback) or a wire rule with an expiry.  Every injection is
  published on the telemetry bus (``chaos_inject`` events, a
  ``faults_injected`` counter, and a ``chaos`` snapshot section).

Plug in via ``ClusterService(chaos=plan)`` or
``ProcessClusterApplication(chaos=plan)``; tests and the CI chaos-smoke
bench drive it hermetically over the InProcessLauncher.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from repro_torch.cluster.wire import (
    Frame,
    FrameConnection,
    FrameType,
    pack_frame_buffers,
)

__all__ = [
    "FAULT_KINDS",
    "Fault",
    "FaultPlan",
    "WireFaults",
    "FaultyConnection",
    "ChaosController",
]

FAULT_KINDS = (
    "kill_node",
    "drop",
    "delay",
    "duplicate",
    "corrupt",
    "stall_heartbeat",
    "partition",
    "partition_peer",
    "straggler",
)

# Which wire frames a fault touches when the user does not say.  Chosen so
# every default is *recoverable*: heartbeat loss and duplication both heal
# through the death-detection / dedup paths, and a corrupt WORK_BATCH
# kills its node (decode error), which the host reaps like any crash.
_DEFAULT_FRAME_TYPES: dict[str, tuple[str, ...]] = {
    "drop": ("HEARTBEAT",),
    "duplicate": ("RESULT_BATCH", "RESULT"),
    "corrupt": ("WORK_BATCH",),
    "stall_heartbeat": ("HEARTBEAT",),
}

# An invalid codec id: the receiver's decode_payload raises ValueError
# ("unknown payload codec") while the stream framing stays aligned — the
# corruption is detected at the protocol layer, not as a hung socket.
_CORRUPT_CODEC = 0x7F
_CODEC_BYTE_OFFSET = 6  # _HEADER = "!4sBBBBII": magic(4) ver ftype codec ...


@dataclass
class Fault:
    """One declarative fault.  ``node=None`` matches every node (wire
    faults only; ``kill_node`` must name its victim).

    Triggers: ``after_items`` fires once the cluster has collected that
    many items (progress-conditioned — "mid-job" without guessing wall
    time); otherwise ``at_s`` fires that many seconds after the
    controller is armed.  ``duration_s=None`` means the wire rule never
    expires; ``count`` caps how many frames it touches; ``probability``
    makes it flaky rather than total.
    """

    kind: str
    node: str | None = None
    at_s: float = 0.0
    after_items: int | None = None
    duration_s: float | None = None
    probability: float = 1.0
    delay_s: float = 0.05
    frame_types: tuple[str, ...] = ()
    count: int | None = None

    def validate(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}"
            )
        if self.kind in ("kill_node", "partition_peer") and not self.node:
            raise ValueError(f"{self.kind} faults must name their node=")
        if not (0.0 < self.probability <= 1.0):
            raise ValueError(
                f"probability must be in (0, 1], got {self.probability}"
            )
        if self.delay_s < 0 or self.at_s < 0:
            raise ValueError("at_s and delay_s must be >= 0")
        if self.count is not None and self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        for name in self.frame_types:
            if name not in FrameType.__members__:
                raise ValueError(f"unknown frame type {name!r}")

    def resolved_frame_types(self) -> frozenset[FrameType] | None:
        """The FrameType filter this fault's wire rule applies (None =
        all frames)."""
        names = self.frame_types or _DEFAULT_FRAME_TYPES.get(self.kind, ())
        if not names:
            return None
        return frozenset(FrameType[name] for name in names)


@dataclass
class FaultPlan:
    """A deterministic (seeded) schedule of faults for one run."""

    faults: list[Fault] = field(default_factory=list)
    seed: int = 0

    def validate(self) -> None:
        for fault in self.faults:
            fault.validate()


class _WireRule:
    """One active wire-level fault: which frames of which node get which
    treatment, until expiry / count exhaustion."""

    def __init__(self, fault: Fault, action: str, direction: str,
                 expires_at: float | None):
        self.fault = fault
        self.action = action  # "drop" | "delay" | "duplicate" | "corrupt"
        self.direction = direction  # "recv" (node->host) | "send" (host->node)
        self.ftypes = fault.resolved_frame_types()
        self.expires_at = expires_at
        self.remaining = fault.count  # None = unbounded
        self.hits = 0

    def expired(self, now: float) -> bool:
        if self.remaining is not None and self.remaining <= 0:
            return True
        return self.expires_at is not None and now >= self.expires_at

    def matches(self, node_id: str | None, direction: str,
                frame: Frame) -> bool:
        if direction != self.direction:
            return False
        if self.fault.node is not None and self.fault.node != node_id:
            return False
        if self.ftypes is not None and frame.ftype not in self.ftypes:
            return False
        return True


class WireFaults:
    """Thread-safe registry of active wire rules.

    Consulted by every :class:`FaultyConnection` on both frame paths; the
    controller installs rules when faults fire and they expire lazily
    here (no rule-removal thread needed).
    """

    def __init__(self, rng: random.Random | None = None):
        self._rules: list[_WireRule] = []
        self._rng = rng or random.Random()
        self._lock = threading.Lock()

    def install(self, rule: _WireRule) -> None:
        with self._lock:
            self._rules.append(rule)

    def active_count(self) -> int:
        now = time.monotonic()
        with self._lock:
            self._rules = [r for r in self._rules if not r.expired(now)]
            return len(self._rules)

    def match(self, node_id: str | None, direction: str,
              frame: Frame) -> _WireRule | None:
        """The first live rule touching this frame (consuming one of its
        ``count`` and rolling its ``probability`` die), or None."""
        now = time.monotonic()
        with self._lock:
            self._rules = [r for r in self._rules if not r.expired(now)]
            for rule in self._rules:
                if not rule.matches(node_id, direction, frame):
                    continue
                if (rule.fault.probability < 1.0
                        and self._rng.random() >= rule.fault.probability):
                    continue
                if rule.remaining is not None:
                    rule.remaining -= 1
                rule.hits += 1
                return rule
        return None


class FaultyConnection:
    """An injectable proxy over one :class:`FrameConnection`.

    Installed by the host's accept loop (``conn_wrapper=``), so *every*
    frame of that node crosses the fault registry.  The wrapped node's
    identity is learned from its REGISTER frame — rules that name a node
    only start matching once it has introduced itself.
    """

    def __init__(self, conn: FrameConnection, faults: WireFaults,
                 node_id: str | None = None):
        self._conn = conn
        self._faults = faults
        self.node_id = node_id
        self._pending: collections.deque[Frame] = collections.deque()

    # -- passthrough surface (everything HostLoader/ChannelMux touches) -----

    @property
    def sock(self):
        return self._conn.sock

    @property
    def counters(self):
        return self._conn.counters

    @property
    def peer(self) -> str:
        return self._conn.peer

    def close(self) -> None:
        self._conn.close()

    # -- the faulted frame paths --------------------------------------------

    def send(self, frame: Frame) -> None:
        rule = self._faults.match(self.node_id, "send", frame)
        if rule is None:
            self._conn.send(frame)
            return
        if rule.action == "drop":
            return  # swallowed: the peer simply never hears it
        if rule.action == "corrupt":
            bufs = pack_frame_buffers(frame)
            header = bytearray(bufs[0])
            header[_CODEC_BYTE_OFFSET] = _CORRUPT_CODEC
            self._conn.send_raw([bytes(header), *bufs[1:]])
            return
        if rule.action == "duplicate":
            self._conn.send(frame)
        self._conn.send(frame)

    def recv(self) -> Frame:
        while True:
            if self._pending:
                return self._pending.popleft()
            frame = self._conn.recv()
            if self.node_id is None and frame.ftype is FrameType.REGISTER:
                self.node_id = (frame.payload or {}).get("node_id")
            rule = self._faults.match(self.node_id, "recv", frame)
            if rule is None:
                return frame
            if rule.action == "drop":
                continue  # the host never sees it
            if rule.action == "delay":
                # Sleeping here stalls only this node's reader thread —
                # the dispatcher and every other node keep their pace.
                time.sleep(rule.fault.delay_s)
                return frame
            if rule.action == "duplicate":
                self._pending.append(frame)
                return frame
            return frame


class ChaosController:
    """Arms a :class:`FaultPlan` against a live cluster.

    ``kill`` is the deployment-layer callback (``kill(node_id) -> bool``);
    ``items_fn`` reports cluster progress for ``after_items`` triggers;
    ``telemetry`` receives one ``chaos_inject`` event per fired fault.
    ``wrap_connection`` is handed to the host's accept loop so wire rules
    reach every node connection.
    """

    POLL_S = 0.005

    def __init__(self, plan: FaultPlan, *,
                 kill: Callable[[str], Any] | None = None,
                 telemetry: Any = None,
                 items_fn: Callable[[], int] | None = None):
        plan.validate()
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self.wire = WireFaults(self._rng)
        self._kill = kill
        self.telemetry = telemetry
        self._items_fn = items_fn
        self.fired: list[dict] = []
        self.injected = 0
        self._armed_at: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # -- plumbing ------------------------------------------------------------

    def wrap_connection(self, conn: FrameConnection) -> FaultyConnection:
        return FaultyConnection(conn, self.wire)

    @property
    def armed(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def arm(self) -> None:
        """Start the trigger clock; idempotent."""
        if self.armed:
            return
        self._stop.clear()
        self._armed_at = time.monotonic()
        self._thread = threading.Thread(target=self._loop, name="chaos",
                                        daemon=True)
        self._thread.start()

    def disarm(self) -> None:
        """Stop firing new faults (already-installed wire rules keep their
        own expiries)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- trigger loop --------------------------------------------------------

    def _loop(self) -> None:
        pending = list(self.plan.faults)
        while pending and not self._stop.is_set():
            now_s = time.monotonic() - self._armed_at
            items = self._items_fn() if self._items_fn is not None else 0
            due = [f for f in pending if self._due(f, now_s, items)]
            for fault in due:
                pending.remove(fault)
                try:
                    self._fire(fault, now_s, items)
                except Exception:
                    pass  # chaos must never take the cluster down itself
            if pending:
                self._stop.wait(self.POLL_S)

    @staticmethod
    def _due(fault: Fault, now_s: float, items: int) -> bool:
        if fault.after_items is not None:
            return items >= fault.after_items
        return now_s >= fault.at_s

    def _fire(self, fault: Fault, now_s: float, items: int) -> None:
        expires = (None if fault.duration_s is None
                   else time.monotonic() + fault.duration_s)
        if fault.kind == "kill_node":
            if self._kill is not None:
                self._kill(fault.node)
        elif fault.kind == "partition":
            # Silence in both directions: the node looks dead to the host
            # and the host looks dead to the node.
            self.wire.install(_WireRule(fault, "drop", "recv", expires))
            self.wire.install(_WireRule(fault, "drop", "send", expires))
        elif fault.kind == "partition_peer":
            # Cut the node's *peer data plane* only — the host link stays
            # healthy, so the control plane sees a live node whose peer
            # edges fail, and senders must walk their fallback targets
            # (ultimately the host relay).  The seam is process-local, so
            # this is only effective under the in-process launcher; under
            # subprocess pools it is a no-op (documented in peer.py).
            from repro_torch.cluster import peer as peer_mod

            peer_mod.partition_node(
                fault.node, fault.duration_s
                if fault.duration_s is not None else 1.0)
        elif fault.kind in ("drop", "stall_heartbeat"):
            self.wire.install(_WireRule(fault, "drop", "recv", expires))
        elif fault.kind in ("delay", "straggler"):
            self.wire.install(_WireRule(fault, "delay", "recv", expires))
        elif fault.kind == "duplicate":
            self.wire.install(_WireRule(fault, "duplicate", "recv", expires))
        elif fault.kind == "corrupt":
            if fault.count is None:
                fault = Fault(**{**vars(fault), "count": 1})
            self.wire.install(_WireRule(fault, "corrupt", "send", expires))
        record = {
            "kind": fault.kind,
            "node": fault.node,
            "at_s": round(now_s, 3),
            "at_item": items,
        }
        with self._lock:
            self.injected += 1
            self.fired.append(record)
        if self.telemetry is not None:
            self.telemetry.inc("faults_injected")
            self.telemetry.emit(
                "chaos_inject",
                fault=fault.kind,
                node=fault.node,
                at_item=items,
                duration_s=fault.duration_s,
                probability=fault.probability,
                delay_s=(fault.delay_s
                         if fault.kind in ("delay", "straggler") else None),
            )

    # -- telemetry sampler ---------------------------------------------------

    def sample(self) -> dict:
        """The ``chaos`` section of the metrics snapshot."""
        with self._lock:
            fired = list(self.fired)
            injected = self.injected
        return {
            "armed": self.armed,
            "faults_planned": len(self.plan.faults),
            "faults_injected": injected,
            "active_wire_rules": self.wire.active_count(),
            "fired": fired,
        }


def chaos_events(events: Iterable[dict]) -> list[dict]:
    """Filter a telemetry event stream down to the chaos/heal story
    (convenience for tests and benches asserting on /events)."""
    kinds = {"chaos_inject", "failure", "heal", "heal_failed", "respawn",
             "job_retry"}
    return [e for e in events if e.get("kind") in kinds]
