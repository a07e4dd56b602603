"""Load-time vs run-time accounting (paper requirement 7).

ClusterBuilder collects, per node, the time spent *loading* the application
(code distribution, channel construction, synchronisation barriers) separately
from the time spent *running* it.  On termination every node returns its
timings to the host, which combines them with its own and prints the table
(paper §4, §8.2: load time was linear in the node count, 132.5 +/- 2.5 ms per
node, and under 1% of total run time).

Beyond the paper we account a third phase, *boot*: the cost of standing up a
node's environment (interpreter start, heavy-dependency imports) before any
code distribution happens.  The paper's workstations pre-exist with a warm
JVM, so §8.2's ~132 ms/node load figure excludes it; splitting boot out keeps
our load numbers comparable.

The collector also aggregates *wire counters* — bytes/frames/round-trips the
cluster transport moved per run — fed by the host loader, so data-plane
regressions are visible as counts, not just seconds.

The threads runtime and the process transport record into it; it holds
nothing specific to one runtime.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass


_PHASES = ("boot", "load", "run")


@dataclass
class NodeTiming:
    """Timing record for a single (logical) node."""

    node_id: str
    boot_ms: float = 0.0
    load_ms: float = 0.0
    run_ms: float = 0.0
    items: int = 0

    def as_dict(self) -> dict:
        return {
            "node_id": self.node_id,
            "boot_ms": round(self.boot_ms, 3),
            "load_ms": round(self.load_ms, 3),
            "run_ms": round(self.run_ms, 3),
            "items": self.items,
        }


class TimingCollector:
    """Thread-safe collector of per-node boot/load/run timings.

    Usage::

        tc = TimingCollector()
        with tc.phase("node0", "load"):
            ...  # channel construction, code transfer
        with tc.phase("node0", "run"):
            ...  # application processing
        print(tc.report())
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nodes: dict[str, NodeTiming] = {}
        self._wire: dict[str, float] = {}

    def node(self, node_id: str) -> NodeTiming:
        with self._lock:
            if node_id not in self._nodes:
                self._nodes[node_id] = NodeTiming(node_id=node_id)
            return self._nodes[node_id]

    def phase(self, node_id: str, kind: str) -> "_PhaseTimer":
        if kind not in _PHASES:
            raise ValueError(
                f"phase kind must be one of {_PHASES}, got {kind!r}"
            )
        return _PhaseTimer(self, node_id, kind)

    def add(self, node_id: str, kind: str, ms: float) -> None:
        if kind not in _PHASES:
            raise ValueError(
                f"phase kind must be one of {_PHASES}, got {kind!r}"
            )
        rec = self.node(node_id)
        with self._lock:
            setattr(rec, f"{kind}_ms", getattr(rec, f"{kind}_ms") + ms)

    def count_item(self, node_id: str, n: int = 1) -> None:
        rec = self.node(node_id)
        with self._lock:
            rec.items += n

    # -- wire counters ------------------------------------------------------

    def add_wire(self, **counts: float) -> None:
        """Accumulate wire-level counters (bytes/frames/round-trips)."""
        with self._lock:
            for key, val in counts.items():
                self._wire[key] = self._wire.get(key, 0) + val

    @property
    def wire(self) -> dict[str, float]:
        with self._lock:
            return dict(self._wire)

    # -- reporting ---------------------------------------------------------

    @property
    def nodes(self) -> list[NodeTiming]:
        with self._lock:
            return sorted(self._nodes.values(), key=lambda r: r.node_id)

    def total_boot_ms(self) -> float:
        return sum(n.boot_ms for n in self.nodes)

    def total_load_ms(self) -> float:
        return sum(n.load_ms for n in self.nodes)

    def total_run_ms(self) -> float:
        return max((n.run_ms for n in self.nodes), default=0.0)

    def load_fraction(self) -> float:
        """Load time as a fraction of total wall time (paper reports <1%)."""
        run = self.total_run_ms()
        load = self.total_load_ms()
        denom = run + load
        return load / denom if denom > 0 else 0.0

    def report(self) -> str:
        lines = [
            f"{'node':<16}{'boot_ms':>12}{'load_ms':>12}{'run_ms':>14}"
            f"{'items':>8}"
        ]
        for rec in self.nodes:
            lines.append(
                f"{rec.node_id:<16}{rec.boot_ms:>12.3f}{rec.load_ms:>12.3f}"
                f"{rec.run_ms:>14.3f}{rec.items:>8d}"
            )
        lines.append(
            f"load fraction of total: {100.0 * self.load_fraction():.3f}%"
        )
        wire = self.wire
        if wire:
            lines.append(
                "wire: " + " ".join(f"{k}={wire[k]:.0f}" for k in sorted(wire))
            )
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps([n.as_dict() for n in self.nodes], indent=2)

    def summary(self) -> dict:
        """One JSON-able dict of everything: per-node phases, phase totals,
        load fraction, and wire counters.  This is what the telemetry
        endpoint exports as its ``timing`` section."""
        return {
            "nodes": {n.node_id: n.as_dict() for n in self.nodes},
            "total_boot_ms": round(self.total_boot_ms(), 3),
            "total_load_ms": round(self.total_load_ms(), 3),
            "total_run_ms": round(self.total_run_ms(), 3),
            "load_fraction": round(self.load_fraction(), 6),
            "wire": self.wire,
        }


class _PhaseTimer:
    def __init__(self, collector: TimingCollector, node_id: str, kind: str):
        self._collector = collector
        self._node_id = node_id
        self._kind = kind
        self._t0 = 0.0

    def __enter__(self) -> "_PhaseTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt_ms = (time.perf_counter() - self._t0) * 1e3
        self._collector.add(self._node_id, self._kind, dt_ms)
