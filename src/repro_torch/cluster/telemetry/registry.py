"""The host-side event bus + metrics registry.

Everything the cluster already knows while a run is live — per-job farm
gauges, per-node wire counters, membership transitions, node-reported
boot/load phases — was invisible outside the process.
This module is the one place those signals meet:

* :class:`Telemetry` is a thread-safe **event bus** (a bounded ring of
  timestamped, sequence-numbered lifecycle events) plus a **metrics
  registry** (per-job gauges, per-node fields, cluster-level counters).
  The dispatcher and the membership layer *push* into it
  at state changes; fast-moving values the producers already maintain
  (wire byte counters, parked credits) are *pulled* at snapshot time
  through registered sampler callbacks, so the hot paths pay nothing for
  them.
* :class:`TraceWriter` appends every bus event as one JSON line, so a
  benchmark or post-mortem can replay the full membership/job lifecycle
  offline (:func:`read_trace`).

The registry is deliberately dependency-free (stdlib only) and knows
nothing about sockets or jobs — producers decide what a gauge means; the
registry stores, snapshots, and exports it (JSON via :meth:`snapshot`,
Prometheus text exposition via :meth:`prometheus`).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, Iterable

__all__ = ["Histogram", "Telemetry", "TraceWriter", "read_trace"]

# Default capacity of the event ring: enough for the full lifecycle of a
# long service run (events are per state change, not per item), bounded so
# an immortal pool can never grow host memory.
EVENT_RING_SLOTS = 1024

# Fixed bucket grids per histogram family, chosen here once so every
# producer observes into the same boundaries (upper bounds, inclusive —
# Prometheus ``le`` semantics; an implicit +Inf bucket closes each grid).
HISTOGRAM_BUCKETS: dict[str, tuple[float, ...]] = {
    # Dispatch-to-completion per item (WORK_BATCH send to result/ack).
    "item_latency_ms": (1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                        1000, 2500, 5000, 10000),
    # Items per RESULT_BATCH frame (how well the flusher coalesces).
    "result_batch_items": (1, 2, 4, 8, 16, 32, 64, 128, 256),
    # Broadcast-block chunk sizes served (host or peer side).
    "block_chunk_bytes": (1 << 12, 1 << 14, 1 << 16, 1 << 18,
                          1 << 20, 1 << 22, 1 << 24),
}
_DEFAULT_BUCKETS = (0.1, 1.0, 10.0, 100.0, 1000.0, 10000.0)


class Histogram:
    """A fixed-bucket cumulative histogram (Prometheus-style).

    Buckets are per-family upper bounds; ``counts[i]`` is the number of
    observations ``<= bounds[i]`` *in that bucket only* (the snapshot and
    exposition cumulate).  Mutation is lock-free per instance — callers go
    through :meth:`Telemetry.observe`, which serializes under the bus lock.
    """

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: tuple[float, ...]):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        i = 0
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.count += 1
        self.sum += value

    def snapshot(self) -> dict:
        """Cumulative view: [[le, count_le], ...] plus count and sum."""
        cum, buckets = 0, []
        for bound, n in zip(self.bounds, self.counts):
            cum += n
            buckets.append([bound, cum])
        return {"buckets": buckets, "count": self.count,
                "sum": round(self.sum, 6)}


class TraceWriter:
    """Append-only JSONL sink for bus events (one event per line).

    Thread-safe (the dispatcher and service threads both emit) and flushed
    per line: a post-mortem after a crash sees every event that was
    emitted, not whatever survived in a userspace buffer.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def write(self, event: dict) -> None:
        line = json.dumps(event, default=str, separators=(",", ":"))
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


def read_trace(path: str) -> list[dict]:
    """Load a JSONL trace back into event dicts (blank lines skipped)."""
    events = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def _deep_merge(base: dict, extra: dict) -> dict:
    """Shallow-copy merge; dict values one level down merge instead of
    replacing (a node's sampled fields join its pushed ``report``)."""
    out = dict(base)
    for key, val in extra.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = {**out[key], **val}
        else:
            out[key] = val
    return out


class Telemetry:
    """Thread-safe event bus + metrics registry (see module docstring).

    Producers push:

    * :meth:`emit` — one lifecycle event onto the ring (and the trace);
    * :meth:`set_job` / :meth:`set_node` — merge-update one job's gauges /
      one node's fields;
    * :meth:`inc` — bump a cluster-level counter (``jobs_completed``...).

    Consumers pull:

    * :meth:`snapshot` — one JSON-able dict of everything (gauges merged
      with whatever the registered samplers report *right now*);
    * :meth:`events_since` — the ring's events after a cursor, in order;
    * :meth:`prometheus` — the snapshot as Prometheus text exposition.

    ``clock`` is injectable for deterministic tests; it must return epoch
    seconds (events are wall-stamped so offline traces line up with logs).
    """

    def __init__(self, *, ring_size: int = EVENT_RING_SLOTS,
                 trace_path: str | None = None,
                 clock: Callable[[], float] = time.time):
        self._lock = threading.Lock()
        self._clock = clock
        self.started_at = clock()
        self._ring: collections.deque = collections.deque(maxlen=ring_size)
        self._seq = 0
        self._dropped = 0
        self._jobs: dict[int, dict] = {}
        self._nodes: dict[str, dict] = {}
        self._counters: dict[str, float] = {}
        self._histograms: dict[str, Histogram] = {}
        # Pull-side sampler callbacks (all optional):
        #   nodes()   -> {node_id: {field: value, ...}} merged per node
        #   cluster() -> {counter: value} merged into the cluster section
        #   timing()  -> arbitrary dict exported as the "timing" section
        self._samplers: dict[str, Callable[[], dict]] = {}
        self.trace: TraceWriter | None = (
            TraceWriter(trace_path) if trace_path else None
        )

    # -- event bus -----------------------------------------------------------

    def emit(self, kind: str, **fields: Any) -> dict:
        """Publish one lifecycle event: sequence-stamped, wall-stamped,
        ring-buffered, and appended to the trace (when one is attached)."""
        with self._lock:
            self._seq += 1
            event = {"seq": self._seq, "ts": round(self._clock(), 6),
                     "kind": kind, **fields}
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(event)
            # The trace write stays under the bus lock so the JSONL file is
            # seq-ordered: concurrent emitters would otherwise race between
            # taking a seq and appending their line.  Events are per state
            # change, not per item, so the line-buffered write is cheap.
            if self.trace is not None:
                self.trace.write(event)
        return event

    def events_since(self, since: int = 0, limit: int = 500) -> list[dict]:
        """Events with ``seq > since``, oldest first, at most ``limit``.

        The cursor contract: pass the largest ``seq`` you have seen to get
        only what is new.  A cursor older than the ring's tail silently
        skips the dropped span (``events_dropped`` in the snapshot says how
        much history was lost overall).
        """
        with self._lock:
            events = [e for e in self._ring if e["seq"] > since]
        return events[:max(0, int(limit))]

    # -- metrics registry ----------------------------------------------------

    def set_job(self, job_id: int, **gauges: Any) -> None:
        with self._lock:
            self._jobs.setdefault(job_id, {}).update(gauges)

    def set_node(self, node_id: str, **fields: Any) -> None:
        with self._lock:
            self._nodes.setdefault(node_id, {}).update(fields)

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def observe(self, name: str, value: float) -> None:
        """Record one observation into the named histogram (created on
        first use with its family's bucket grid)."""
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = Histogram(
                    HISTOGRAM_BUCKETS.get(name, _DEFAULT_BUCKETS))
                self._histograms[name] = hist
            hist.observe(float(value))

    def set_sampler(self, name: str, fn: Callable[[], dict]) -> None:
        """Register a pull-side sampler (``"nodes"``, ``"cluster"`` or
        ``"timing"``) — invoked on every snapshot, on the reader's thread.
        (The JAX package's fault injector and job gateway add sections of
        their own; neither is ported yet.)"""
        if name not in ("nodes", "cluster", "timing"):
            raise ValueError(f"unknown sampler section {name!r}")
        self._samplers[name] = fn

    def _sample(self, name: str) -> dict:
        fn = self._samplers.get(name)
        if fn is None:
            return {}
        try:
            return fn() or {}
        except Exception:  # a sampler must never take the endpoint down
            return {}

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """One consistent-enough view of everything, JSON-able as-is.

        Pushed gauges are copied under the lock; sampled values (wire
        counters, parked credits, host stats) are read live — they are
        monotonic counters whose exact interleaving does not matter for
        reporting.
        """
        sampled_nodes = self._sample("nodes")
        sampled_cluster = self._sample("cluster")
        timing = self._sample("timing")
        now = self._clock()
        with self._lock:
            jobs = {str(jid): dict(g) for jid, g in self._jobs.items()}
            nodes = {nid: dict(f) for nid, f in self._nodes.items()}
            counters = dict(self._counters)
            histograms = {name: h.snapshot()
                          for name, h in self._histograms.items()}
            seq, dropped = self._seq, self._dropped
        for nid, fields in sampled_nodes.items():
            nodes[nid] = _deep_merge(nodes.get(nid, {}), fields)
        cluster = {**counters, **sampled_cluster}
        # Cluster-wide wire totals, summed over whatever the nodes report.
        totals: dict[str, float] = {}
        for fields in nodes.values():
            for key, val in (fields.get("wire") or {}).items():
                totals[key] = totals.get(key, 0) + val
        for key, val in totals.items():
            cluster.setdefault(f"wire_{key}", val)
        snap = {
            "ts": round(now, 6),
            "uptime_s": round(now - self.started_at, 6),
            "monotonic": time.monotonic(),
            "cluster": cluster,
            "jobs": jobs,
            "nodes": nodes,
            "events": {"next": seq, "dropped": dropped},
        }
        if histograms:
            snap["histograms"] = histograms
        if timing:
            snap["timing"] = timing
        return snap

    def prometheus(self) -> str:
        """The snapshot as Prometheus text exposition (version 0.0.4).

        Families (all gauges — the scraper owns rate computation):

        * ``repro_uptime_seconds``
        * ``repro_cluster_<counter>`` — cluster section, numeric entries;
        * ``repro_job_<gauge>{job="1"}`` — per-job numerics; per-stage
          list gauges add a ``stage`` label per element;
        * ``repro_node_<field>{node="node0"}`` — per-node numerics, with
          nested dicts flattened (``wire`` -> ``repro_node_wire_bytes_sent``)
          and the state string exported as ``repro_node_state{state=...} 1``.
        """
        snap = self.snapshot()
        families: dict[str, list[tuple[str, float]]] = {}

        def sample(family: str, labels: dict, value: Any) -> None:
            if isinstance(value, bool):
                value = int(value)
            if not isinstance(value, (int, float)):
                return
            label_s = ",".join(
                f'{k}="{_escape_label(str(v))}"'
                for k, v in sorted(labels.items())
            )
            families.setdefault(family, []).append(
                (f"{{{label_s}}}" if label_s else "", float(value))
            )

        sample("repro_uptime_seconds", {}, snap["uptime_s"])
        for key, val in snap["cluster"].items():
            sample(f"repro_cluster_{key}", {}, val)
        for jid, gauges in snap["jobs"].items():
            for key, val in gauges.items():
                if isinstance(val, (list, tuple)):
                    for s, elem in enumerate(val):
                        sample(f"repro_job_{key}",
                               {"job": jid, "stage": s}, elem)
                else:
                    sample(f"repro_job_{key}", {"job": jid}, val)
        for nid, fields in snap["nodes"].items():
            flat = dict(fields)
            for nest in ("wire", "report"):
                for key, val in (flat.pop(nest, None) or {}).items():
                    flat[f"{nest}_{key}"] = val
            state = flat.pop("state", None)
            if state is not None:
                sample("repro_node_state", {"node": nid, "state": state}, 1)
            flat.pop("transitions", None)
            for key, val in flat.items():
                sample(f"repro_node_{key}", {"node": nid}, val)
        lines = []
        for family in sorted(families):
            lines.append(f"# TYPE {family} gauge")
            for labels, value in sorted(families[family]):
                value_s = f"{value:g}"
                lines.append(f"{family}{labels} {value_s}")
        hists = snap.get("histograms") or {}
        for name in sorted(hists):
            h = hists[name]
            family = f"repro_{name}"
            lines.append(f"# TYPE {family} histogram")
            for le, cum in h["buckets"]:
                lines.append(f'{family}_bucket{{le="{le:g}"}} {cum}')
            lines.append(f'{family}_bucket{{le="+Inf"}} {h["count"]}')
            lines.append(f"{family}_sum {h['sum']:g}")
            lines.append(f"{family}_count {h['count']}")
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        if self.trace is not None:
            self.trace.close()


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def total_counts(dicts: Iterable[dict]) -> dict:
    """Sum a stream of flat numeric dicts key-wise (wire-counter folding)."""
    totals: dict[str, float] = {}
    for d in dicts:
        for key, val in d.items():
            totals[key] = totals.get(key, 0) + val
    return totals
