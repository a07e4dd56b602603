"""Load-time vs run-time accounting (paper requirement 7).

ClusterBuilder collects, per node, the time spent *loading* the application
(code distribution, channel construction, synchronisation barriers) separately
from the time spent *running* it.  On termination every node returns its
timings to the host, which combines them with its own and prints the table
(paper §4, §8.2: load time was linear in the node count, 132.5 +/- 2.5 ms per
node, and under 1% of total run time).

The threads runtime records into it; it holds nothing specific to one
runtime.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


_PHASES = ("load", "run")


@dataclass
class NodeTiming:
    """Timing record for a single (logical) node."""

    node_id: str
    load_ms: float = 0.0
    run_ms: float = 0.0
    items: int = 0

    def as_dict(self) -> dict:
        return {
            "node_id": self.node_id,
            "load_ms": round(self.load_ms, 3),
            "run_ms": round(self.run_ms, 3),
            "items": self.items,
        }


class TimingCollector:
    """Thread-safe collector of per-node load/run timings.

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

    # -- reporting ---------------------------------------------------------

    @property
    def nodes(self) -> list[NodeTiming]:
        with self._lock:
            return sorted(self._nodes.values(), key=lambda r: r.node_id)

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
            f"{'node':<16}{'load_ms':>12}{'run_ms':>14}"
            f"{'items':>8}"
        ]
        for rec in self.nodes:
            lines.append(
                f"{rec.node_id:<16}{rec.load_ms:>12.3f}"
                f"{rec.run_ms:>14.3f}{rec.items:>8d}"
            )
        lines.append(
            f"load fraction of total: {100.0 * self.load_fraction():.3f}%"
        )
        return "\n".join(lines)

    def summary(self) -> dict:
        """One JSON-able dict of everything: per-node phases, phase totals
        and the load fraction."""
        return {
            "nodes": {n.node_id: n.as_dict() for n in self.nodes},
            "total_load_ms": round(self.total_load_ms(), 3),
            "total_run_ms": round(self.total_run_ms(), 3),
            "load_fraction": round(self.load_fraction(), 6),
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
