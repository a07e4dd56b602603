"""Node registry + heartbeat tracking for the Host-Node-Loader.

The paper's HNL learns the cluster's membership from the registration
messages arriving on the load network (port 2000 / channel 1) and assumes
workstations stay up; we extend that with the standard heartbeat liveness
protocol so a dead Node-Loader subprocess is *detected* (via
:class:`repro_torch.runtime.failures.HeartbeatMonitor` thresholds) and its
in-flight work re-dispatched — the same detect→recover control path the SPMD
executor exercises with injected ``node_loss`` events, now driven by a real
process death.

Pure bookkeeping: no sockets here.  The host loader feeds events in
(``register``/``beat``/``mark_*``) and polls :meth:`Membership.reap` from
its dispatcher loop.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any

from repro_torch.runtime.failures import FailureEvent, HeartbeatMonitor

# Node lifecycle:
#   LAUNCHING -(REGISTER)-> REGISTERED -(LOAD)-> LOADED -(UT ack)-> DONE
#       |                        \-----------(missed beats)-------> DEAD
#       \-(respawned elsewhere)-> REPLACED -(its launch registers late)
#                                     \------(REGISTER)-----------> REGISTERED
# LAUNCHING records exist only when the deployment layer announces expected
# launches up front (``expect``); direct ``register`` calls still create
# records from scratch (an unannounced/elastic node).
LAUNCHING = "launching"
REGISTERED = "registered"
LOADED = "loaded"
DONE = "done"
DEAD = "dead"
REPLACED = "replaced"


@dataclass
class NodeRecord:
    node_id: str
    index: int  # dense index, used as FailureEvent.node
    address: str  # observed peer ip:port
    cores: int = 1
    pid: int = 0
    state: str = REGISTERED
    attempts: int = 1  # launch attempts (respawns bump the replacement's)
    launched_at: float = 0.0  # when the launch was announced (expect)
    registered_at: float = 0.0
    last_beat: float = 0.0
    beats: int = 0
    items_done: int = 0
    # Outstanding demand the host could not satisfy yet (credit-based
    # pipelining): credits the node sent that are parked until new items
    # appear (re-dispatch) or the job terminates (answered with UT).
    credits: int = 0
    # Multi-job service state.  ``jobs_loaded`` holds the job ids whose LOAD
    # this node has acked — the host only dispatches job-J work to a node
    # once J is in here (no work-before-code races).  ``code_digests`` is
    # the host-side mirror of the node's warm code-cache LRU (digest ->
    # None, insertion-ordered, same capacity and touch order as the node's),
    # so the host knows which stage functions it can skip re-shipping.
    jobs_loaded: set = field(default_factory=set)
    code_digests: collections.OrderedDict = field(
        default_factory=collections.OrderedDict
    )
    timing: dict[str, Any] = field(default_factory=dict)
    conn: Any = None  # FrameConnection; opaque to this module
    # Observability: when the current state was entered, and the full
    # (state, monotonic time) history — the events feed and dashboard show
    # *when* a node registered/died/was replaced, not just that it did.
    state_changed_at: float = 0.0
    transitions: list = field(default_factory=list)
    # The FailureEvent recorded when this node was declared dead (None
    # while alive) — the heal path reads its detection metadata.
    last_failure: Any = None
    # Graceful retirement (pool shrink): set when the host decided to UT
    # this node mid-run.  A retiring node is fenced from new work
    # (``_answer`` skips it) but stays ``alive`` until its UT ack lands —
    # its in-flight items are requeued there, not reaped as a death.
    retiring: bool = False
    # Listening port of the node's peer data-plane server (0 = none
    # reported; the node is unreachable for peer routing / block trading
    # and routing tables simply omit it).
    peer_port: int = 0

    @property
    def alive(self) -> bool:
        return self.state in (REGISTERED, LOADED)


class Membership:
    """The HNL's view of the cluster, with heartbeat-based death detection."""

    def __init__(self, monitor: HeartbeatMonitor | None = None):
        self.monitor = monitor or HeartbeatMonitor()
        self.nodes: dict[str, NodeRecord] = {}
        self.failures: list[FailureEvent] = []
        # Observability hook: called as on_transition(rec, old_state) after
        # every state change.  The host loader wires this to the telemetry
        # bus; pure-bookkeeping users leave it None.
        self.on_transition: Any = None

    def _transition(self, rec: NodeRecord, state: str,
                    now: float | None = None) -> None:
        """Single choke point for state changes: stamps the time, records
        the history, and fires ``on_transition``."""
        now = time.monotonic() if now is None else now
        old = rec.state
        rec.state = state
        rec.state_changed_at = now
        rec.transitions.append((state, now))
        if self.on_transition is not None:
            self.on_transition(rec, old)

    def expect(self, node_id: str, now: float | None = None) -> NodeRecord:
        """Announce a launch: a record in LAUNCHING until REGISTER arrives."""
        if node_id in self.nodes:
            raise ValueError(f"duplicate launch announcement for {node_id!r}")
        now = time.monotonic() if now is None else now
        rec = NodeRecord(
            node_id=node_id,
            index=len(self.nodes),
            address="",
            state=LAUNCHING,
            launched_at=now,
            state_changed_at=now,
        )
        rec.transitions.append((LAUNCHING, now))
        self.nodes[node_id] = rec
        return rec

    def retract(self, node_id: str, now: float | None = None) -> bool:
        """Withdraw a launch announcement whose launch never produced a
        process (``launcher.launch`` raised): the record leaves LAUNCHING
        — straight to DEAD, with no FailureEvent since there was never a
        node to lose — so it stops counting as capacity on its way and
        stops keeping stages eligible.  Refused (False) once the node
        registered or otherwise left LAUNCHING."""
        rec = self.nodes.get(node_id)
        if rec is None or rec.state != LAUNCHING:
            return False
        self._transition(rec, DEAD, now)
        rec.credits = 0
        return True

    def register(self, node_id: str, address: str, *, cores: int = 1,
                 pid: int = 0, conn: Any = None, peer_port: int = 0,
                 now: float | None = None) -> NodeRecord:
        now = time.monotonic() if now is None else now
        rec = self.nodes.get(node_id)
        if rec is not None:
            # An announced launch showing up — or a replaced launch arriving
            # late, which is still a usable worker (exactly-once collection
            # is guaranteed by result-id dedup, so admit it).
            if rec.state not in (LAUNCHING, REPLACED):
                raise ValueError(f"duplicate registration for {node_id!r}")
            rec.address = address
            rec.cores = cores
            rec.pid = pid
            rec.conn = conn
            rec.peer_port = peer_port
            rec.registered_at = rec.last_beat = now
            self._transition(rec, REGISTERED, now)
            return rec
        rec = NodeRecord(
            node_id=node_id,
            index=len(self.nodes),
            address=address,
            cores=cores,
            pid=pid,
            launched_at=now,
            registered_at=now,
            last_beat=now,
            conn=conn,
            peer_port=peer_port,
            state=LAUNCHING,
        )
        self.nodes[node_id] = rec
        self._transition(rec, REGISTERED, now)
        return rec

    def replace(self, node_id: str) -> NodeRecord:
        """A silent launch was respawned elsewhere: retire the old attempt."""
        rec = self.nodes[node_id]
        if rec.state != LAUNCHING:
            raise ValueError(
                f"cannot replace {node_id!r} in state {rec.state!r}"
            )
        self._transition(rec, REPLACED)
        return rec

    def beat(self, node_id: str, now: float | None = None) -> None:
        rec = self.nodes.get(node_id)
        if rec is None or not rec.alive:
            return  # late beat from an already-reaped node: ignore
        rec.last_beat = time.monotonic() if now is None else now
        rec.beats += 1

    def mark_loaded(self, node_id: str) -> None:
        self._transition(self.nodes[node_id], LOADED)

    def mark_done(self, node_id: str, timing: dict[str, Any] | None = None) -> None:
        rec = self.nodes[node_id]
        self._transition(rec, DONE)
        if timing:
            rec.timing = dict(timing)

    def mark_dead(self, node_id: str, *, at_item: int = 0,
                  now: float | None = None) -> FailureEvent | None:
        rec = self.nodes.get(node_id)
        if rec is None or rec.state == DEAD:
            return None
        now = time.monotonic() if now is None else now
        self._transition(rec, DEAD, now)
        rec.credits = 0  # a dead node's parked demand can never be answered
        # Detection latency: silence observed before we declared death —
        # bounded below by the monitor deadline when beats ever arrived.
        latency = max(0.0, now - rec.last_beat) if rec.last_beat else 0.0
        ev = FailureEvent(step=at_item, kind="node_loss", node=rec.index,
                          node_id=node_id, detect_latency_s=latency)
        self.failures.append(ev)
        rec.last_failure = ev
        return ev

    # -- liveness -----------------------------------------------------------

    def reap(self, now: float | None = None, *, at_item: int = 0
             ) -> list[NodeRecord]:
        """Declare nodes whose heartbeats exceeded the threshold dead."""
        now = time.monotonic() if now is None else now
        newly_dead = []
        for rec in self.nodes.values():
            if rec.alive and self.monitor.is_dead(rec.last_beat, now):
                self.mark_dead(rec.node_id, at_item=at_item, now=now)
                newly_dead.append(rec)
        return newly_dead

    # -- queries ------------------------------------------------------------

    def alive_nodes(self) -> list[NodeRecord]:
        return [r for r in self.nodes.values() if r.alive]

    def launching_nodes(self) -> list[NodeRecord]:
        return [r for r in self.nodes.values() if r.state == LAUNCHING]

    def arrived_count(self) -> int:
        """Launches that turned into real cluster members (any state past
        LAUNCHING, except abandoned REPLACED attempts)."""
        return sum(1 for r in self.nodes.values()
                   if r.state not in (LAUNCHING, REPLACED))

    def finished(self) -> bool:
        """True when no node is still expected to produce anything.

        LAUNCHING records (a degraded start's missing stragglers, still
        eligible to late-join) and REPLACED ones don't block termination —
        only members that actually joined the application network do.
        """
        return all(r.state not in (REGISTERED, LOADED)
                   for r in self.nodes.values())

    def describe(self, now: float | None = None) -> str:
        now = time.monotonic() if now is None else now
        lines = [f"{'node':<10}{'state':<12}{'addr':<22}{'beats':>6}"
                 f"{'items':>7}{'in-state':>10}"]
        for r in sorted(self.nodes.values(), key=lambda r: r.index):
            in_state = now - r.state_changed_at if r.state_changed_at else 0.0
            lines.append(
                f"{r.node_id:<10}{r.state:<12}{r.address:<22}"
                f"{r.beats:>6d}{r.items_done:>7d}{in_state:>9.1f}s"
            )
        return "\n".join(lines)
