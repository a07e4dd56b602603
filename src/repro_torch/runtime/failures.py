"""Failure vocabulary and detection of the runtimes.

Node death on the process transport is *detected* by missed heartbeats
(``HeartbeatMonitor``, used by ``repro_torch.cluster.membership``) and
recorded as a ``FailureEvent``; the simulated-failure records keep the
vocabulary the JAX package shares between its backends.  Detection
thresholds follow standard heartbeat/step-time practice.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Literal

# The node beacon and the host threshold share one default interval so
# neither side beats at a rate the other does not expect.  Guarded so the
# runtime layer stays usable if the cluster transport (or its optional
# deps) is ever stripped from a deployment.
try:
    from repro_torch.cluster.wire import DEFAULT_HEARTBEAT_S
except ImportError:  # pragma: no cover - cluster package absent
    DEFAULT_HEARTBEAT_S = 0.2

FailureKind = Literal["crash", "node_loss", "straggler"]


class WorkFunctionError(RuntimeError):
    """The user's work function raised inside a worker; the job fails fast.

    Shared by every backend so a spec validated on the threads runtime
    (paper §6.1 single-host confidence building) fails with the same
    exception type it would on the real cluster.
    """


class SimulatedNodeFailure(RuntimeError):
    def __init__(self, step: int, kind: FailureKind, node: int):
        super().__init__(f"simulated {kind} of node {node} at step {step}")
        self.step = step
        self.kind = kind
        self.node = node


@dataclass
class FailureEvent:
    """Shared failure vocabulary for both backends.

    The SPMD executor records simulated events (``step``/``node`` index);
    the real transport's membership layer records *detected* ones and
    fills the detection metadata: the dead node's string id and how long
    the heartbeat monitor took to notice after the last beat.  Telemetry
    consumers (``failure`` bus events, ``/metrics``) read the superset.
    """

    step: int
    kind: FailureKind = "crash"
    node: int = 0
    # straggler: multiplicative slowdown applied to the injected node
    slowdown: float = 4.0
    # detection metadata (real transport only; defaults for simulated events)
    node_id: str = ""
    detect_latency_s: float = 0.0


@dataclass
class FailurePlan:
    events: list[FailureEvent] = field(default_factory=list)
    _fired: set = field(default_factory=set)

    def check(self, step: int) -> FailureEvent | None:
        for ev in self.events:
            if ev.step == step and id(ev) not in self._fired:
                self._fired.add(id(ev))
                return ev
        return None


@dataclass
class HeartbeatMonitor:
    """Missed-heartbeat node-death detection (paper-style workstation loss).

    A node is declared dead after ``misses`` consecutive missed beats — the
    standard heartbeat threshold (cf. GFS/Borg practice).  Used by the real
    multi-process transport (``repro_torch.cluster.membership``): a dead subprocess
    triggers the same re-dispatch path the injected ``node_loss`` events
    exercise in the SPMD executor.
    """

    interval_s: float = DEFAULT_HEARTBEAT_S
    misses: int = 5

    @property
    def deadline_s(self) -> float:
        return self.interval_s * self.misses

    def is_dead(self, last_beat_s: float, now_s: float) -> bool:
        return (now_s - last_beat_s) > self.deadline_s


@dataclass
class StragglerMonitor:
    """Step-time EMA + median straggler detection.

    In SPMD every device runs in lockstep, so a straggling node slows the
    *whole step* (the collectives wait).  Detection is therefore on the
    global step time; mitigation is demand-driven re-dispatch at the data
    layer where possible (the paper's client-server protocol, exercised by
    the DSL runtime) or elastic exclusion of the slow node (executor path).
    """

    window: int = 32
    threshold: float = 2.0
    times: list[float] = field(default_factory=list)

    def record(self, step_time_s: float) -> bool:
        """Returns True when the last step looks straggler-afflicted."""
        self.times.append(step_time_s)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < 8:
            return False
        med = statistics.median(self.times[:-1])
        return step_time_s > self.threshold * med

    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0
