"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer metrics read.

The reduction works on the profiler's raw events (no chrome trace is
written).  Device operations (kernels, copies, fills) give the busy time
and the time by kernel name.  A kernel belongs to a span (a
``record_function`` range: the program's own ``attention``, ``moe_ffn``
and ``moe_experts``, or the benchmark's ``bench.*`` ranges) when the host
call that launched it, found by its correlation id, lies inside that
span on the host.  The window is the benchmark's ``bench.window`` range.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from contextlib import contextmanager

WINDOW_SPAN = "bench.window"
_GAP_LABELS = 200_000  # the longest idle gaps that are named by the host's work
_SCAN_BACK = 64  # host events searched back for one that covers a gap


@contextmanager
def profiled(enabled: bool):
    """A profiler over the block when ``enabled``; yields it, or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False) as prof:
        yield prof


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and parameters."""
    name = re.sub(r"^void\s+", "", name)
    for stop in ("<", "("):
        cut = name.find(stop)
        if cut > 0:
            name = name[:cut]
    return name[:120]


# A launch record: a host event named after a CUDA runtime or driver call,
# which carries the correlation id of what it put on the device.
_API = re.compile(r"^(cuda[A-Z]|cu[A-Z])")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """The device's timeline and the host's spans of one traced window."""

    def __init__(self, prof):
        """Each event is a device op, a device annotation (the device's copy
        of a ``record_function`` range, skipped: the host's range says where
        a launch was made), a launch record, a host annotation or another
        host op."""
        from torch.autograd import DeviceType

        cpu, api = DeviceType.CPU, _API.match
        launch_at: dict[int, int] = {}  # launch record's correlation -> host ns
        spans: dict[str, list] = defaultdict(list)
        host: list[tuple[int, int, str]] = []
        ops: list[tuple[str, int, int, int]] = []
        device_annotations = launches = 0
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != cpu:
                if ev.is_user_annotation():
                    device_annotations += 1
                else:
                    ops.append((ev.name(), ev.start_ns(), ev.end_ns(),
                                ev.correlation_id()))
                continue
            name = ev.name()
            if ev.is_user_annotation():
                start, end = ev.start_ns(), ev.end_ns()
                spans[name].append((start, end))
                host.append((start, end, name))
            elif api(name):
                launch_at[ev.correlation_id()] = ev.start_ns()
                launches += 1
            else:
                host.append((ev.start_ns(), ev.end_ns(), name))
        annotations = sum(len(v) for v in spans.values())
        kinds = {"device_op": len(ops), "device_annotation": device_annotations,
                 "launch": launches, "annotation": annotations,
                 "host_op": len(host) - annotations}
        windows = spans.get(WINDOW_SPAN)
        if not windows:
            raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} range")
        self.t0, self.t1 = windows[0][0], windows[-1][1]
        self.event_kinds = {k: v for k, v in kinds.items() if v}
        # each device op with the host time of its launch (None without a
        # launch record), clipped to the window
        self.ops = [(n, max(s, self.t0), min(e, self.t1), launch_at.get(c))
                    for n, s, e, c in ops if e > self.t0 and s < self.t1]
        self._spans = {k: sorted(v) for k, v in spans.items()}
        host.sort()
        self._host = host
        self._host_starts = [h[0] for h in host]
        self.busy = _merge((s, e) for _n, s, e, _c in self.ops)
        self.unattributed = sum(1 for op in self.ops if op[3] is None)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def device_s(self, pattern: str | None = None) -> float:
        """Seconds of device operations whose name matches ``pattern`` (all
        of them without one)."""
        rx = re.compile(pattern) if pattern else None
        return sum(e - s for n, s, e, _c in self.ops
                   if rx is None or rx.search(n)) / 1e9

    def device_s_in(self, span: str) -> float | None:
        """Seconds of device operations launched inside host spans named
        ``span``; None where the trace has no such span."""
        host = self._spans.get(span)
        if not host:
            return None
        starts = [s for s, _e in host]
        total = 0
        for _n, s, e, at in self.ops:
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= host[i][1]:
                total += e - s
        return total / 1e9

    def _host_label(self, t: int) -> str:
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - _SCAN_BACK, -1), -1):
            s, e, name = self._host[j]
            if e >= t:
                return name
        return "host idle or untraced"

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle time
        of the window by what the host was doing when each gap opened."""
        by_op: dict[str, int] = defaultdict(int)
        for n, s, e, _c in self.ops:
            by_op[short_name(n)] += e - s
        gaps, last = [], self.t0
        for s, e in self.busy:
            if s > last:
                gaps.append((s - last, last))
            last = max(last, e)
        if self.t1 > last:
            gaps.append((self.t1 - last, last))
        gaps.sort(reverse=True)
        by_host: dict[str, int] = defaultdict(int)
        for length, at in gaps[:_GAP_LABELS]:
            by_host[self._host_label(at)] += length
        rest = sum(length for length, _at in gaps[_GAP_LABELS:])
        if rest:
            by_host["shorter gaps"] += rest

        def top(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
