"""Interval arithmetic over a traced window for the readers of the
program's own spans (``serve.step``, ``serve.admit``, ``model.decode``,
``attention.decode``, ``train.forward``, ``train.backward``,
``train.optimizer``).

Every span is clipped to the window, and spans of one name are merged.
A device operation belongs to a span when its launch, on the host, lies
inside it (``Trace.ops`` carries each op's launch time).  Idle time is
the window less ``Trace.busy``, so its parts add up to the idle time that
``device.idle_share.*`` reads.  A trace without the span reads None.
"""

from __future__ import annotations

import bisect

from port_bench import trace as trace_mod


def clipped(trace, name: str) -> list[tuple[int, int]]:
    """The host spans ``name`` that overlap the window, each clipped to it,
    in order of start (not merged)."""
    return [(max(s, trace.t0), min(e, trace.t1))
            for s, e in trace._spans.get(name, ()) if e > trace.t0 and s < trace.t1]


def merged(intervals) -> list[tuple[int, int]]:
    return [(s, e) for s, e in trace_mod._merge(intervals)]


def overlap(a, b) -> int:
    """Length of the intersection of two merged interval lists."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def minus(a, b) -> list[tuple[int, int]]:
    """The merged intervals ``a`` less the merged intervals ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def idle(trace) -> list[tuple[int, int]]:
    """The window's gaps with no device operation."""
    return minus([(trace.t0, trace.t1)], trace.busy)


def launched_in(trace, name: str) -> list[tuple]:
    """The window's device operations launched inside spans ``name``."""
    spans = merged(clipped(trace, name))
    starts = [s for s, _e in spans]
    out = []
    for op in trace.ops:
        at = op[3]
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= spans[i][1]:
            out.append(op)
    return out


def device_ms(ops) -> float:
    return sum(e - s for _n, s, e, _at in ops) / 1e6


def serve_idle_ms(trace) -> dict | None:
    """Device idle milliseconds a ``serve.step`` span, split by what the
    engine had open: ``admit`` (a ``serve.admit`` span), ``tick`` (a step
    outside its admissions) and ``caller`` (no step: the caller between
    steps).  The three times the steps give the window's idle time."""
    steps = clipped(trace, "serve.step")
    if not steps:
        return None
    gaps = idle(trace)
    step, admit = merged(steps), merged(clipped(trace, "serve.admit"))
    in_admit = overlap(gaps, admit)
    in_tick = overlap(gaps, minus(step, admit))
    in_caller = sum(e - s for s, e in gaps) - in_admit - in_tick
    return {k: v / 1e6 / len(steps) for k, v in
            (("admit", in_admit), ("tick", in_tick), ("caller", in_caller))}


def per_decode(trace, total: float) -> float | None:
    """``total`` over the window's ``model.decode`` spans; None without one."""
    n = len(clipped(trace, "model.decode"))
    return total / n if n else None


def train_ms(trace, counts, name: str) -> float | None:
    """Device milliseconds a training step launched inside spans ``name``."""
    if not counts.get("steps") or not clipped(trace, name):
        return None
    return device_ms(launched_in(trace, name)) / counts["steps"]
