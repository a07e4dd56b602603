"""The readers of the program's own spans, on fake profiler events built
as the card's torch gives them: idle time split by the engine's spans,
device time and launches of a decode tick, and a training step split
into forward, backward and optimizer; every span clipped to the window."""

from types import SimpleNamespace

import pytest

from port_bench import cell as cell_mod, spans, trace
from port_bench.tests.small import ROOT
from port_bench.tests.test_port_bench_trace import MS, Ev

SERVE = ("serve.idle_admit_ms", "serve.idle_tick_ms", "serve.idle_caller_ms",
         "serve.decode_device_ms", "serve.decode_launches", "serve.decode_attention_ms")
TRAIN = ("train.forward_ms", "train.backward_ms", "train.optimizer_ms")


def _trace(events):
    results = SimpleNamespace(events=lambda: events)
    return trace.Trace(SimpleNamespace(profiler=SimpleNamespace(kineto_results=results)))


def _launched(corr, at, start, end, name="kernel"):
    return [Ev("cudaLaunchKernel", "cuda_runtime", at * MS, at * MS + 10, corr=corr),
            Ev(name, "kernel", start * MS, end * MS, corr, True)]


def _span(name, start, end):
    return Ev(name, "user_annotation", start * MS, end * MS)


def serving_events():
    """Three steps: one that began before the window, one admission and a
    tick, and one that outlasts the window."""
    return [
        _span(trace.WINDOW_SPAN, 0, 100),
        _span("serve.step", -20, 5),
        _span("serve.step", 10, 50), _span("serve.admit", 10, 30),
        _span("bench.prefill", 11, 26), _span("model.prefill", 12, 25),
        _span("bench.decode", 31, 46), _span("model.decode", 32, 45),
        _span("attention", 33, 40), _span("attention.decode", 34, 38),
        _span("serve.step", 60, 120), _span("serve.admit", 60, 70),
        _span("model.decode", 75, 95),
        *_launched(1, 13, 14, 20),  # the prefill
        *_launched(2, 35, 36, 42),  # attention over the cache
        *_launched(3, 33, 42, 44),  # the tick, outside attention.decode
        *_launched(4, 62, 63, 66),  # the second admission
        *_launched(5, 80, 80, 90),  # the second tick
    ]


def _read(workload, tr, counts, names):
    cell = cell_mod.resolve(ROOT, workload)
    got = {m["name"]: r.read(tr, counts, cell.config) for m, r in cell.per_layer}
    assert set(names) <= set(got)
    return got


def test_idle_is_split_by_the_engine_spans_and_adds_up():
    tr = _trace(serving_events())
    # busy 14-20, 36-44, 63-66, 80-90: 27 of 100 ms; the gap 44-63 runs
    # across the tick (44-50), the caller (50-60) and an admission (60-63)
    assert spans.idle(tr) == [(0, 14 * MS), (20 * MS, 36 * MS), (44 * MS, 63 * MS),
                              (66 * MS, 80 * MS), (90 * MS, 100 * MS)]
    counts = {"window_s": 0.1, "prefill_lens": [16]}
    got = _read("yi-serve-docs-c64", tr, counts, SERVE)
    steps = 3  # each span that overlaps the window, clipped to it
    assert got["serve.idle_admit_ms"] == pytest.approx((4 + 10 + 3 + 4) / steps)
    assert got["serve.idle_tick_ms"] == pytest.approx((5 + 6 + 6 + 10 + 10) / steps)
    assert got["serve.idle_caller_ms"] == pytest.approx((5 + 10) / steps)
    idle_ms = sum(got[n] for n in SERVE[:3]) * steps
    assert idle_ms == pytest.approx(got["device.idle_share.serve"] / 100 * 100.0)
    assert idle_ms == pytest.approx((tr.window_s - tr.busy_s) * 1e3)


def test_a_decode_tick_and_its_attention():
    got = _read("yi-serve-docs-c64", _trace(serving_events()), {"window_s": 0.1}, SERVE)
    assert got["serve.decode_device_ms"] == pytest.approx((6 + 2 + 10) / 2)
    assert got["serve.decode_launches"] == pytest.approx(3 / 2)
    assert got["serve.decode_attention_ms"] == pytest.approx(6 / 2)
    tr = _trace(serving_events())
    assert spans.device_ms(spans.launched_in(tr, "model.prefill")) == \
        pytest.approx(tr.device_s_in("bench.prefill") * 1e3)


def test_a_span_across_the_window_edge_counts_only_inside():
    events = [_span(trace.WINDOW_SPAN, 0, 100),
              _span("model.decode", -30, 10), _span("model.decode", 90, 130),
              *_launched(1, -20, 1, 3),  # launched before the window opened
              *_launched(2, 5, 5, 8), *_launched(3, 95, 95, 99),
              *_launched(4, 120, 120, 125)]  # after it closed
    tr = _trace(events)
    assert spans.clipped(tr, "model.decode") == [(0, 10 * MS), (90 * MS, 100 * MS)]
    assert [op[3] for op in spans.launched_in(tr, "model.decode")] == [5 * MS, 95 * MS]
    got = _read("yi-serve-docs-c64", tr, {}, SERVE)
    assert got["serve.decode_device_ms"] == pytest.approx((3 + 4) / 2)
    # no serve.step span: the idle readers read nothing; no attention.decode
    assert got["serve.idle_tick_ms"] is None and got["serve.decode_attention_ms"] == 0


def training_events():
    return [
        _span(trace.WINDOW_SPAN, 0, 100),
        _span("train.forward", -10, 20), _span("train.backward", 20, 40),
        _span("train.optimizer", 40, 48),
        _span("train.forward", 50, 60), _span("train.backward", 60, 80),
        _span("train.optimizer", 80, 110),
        *_launched(1, -5, -3, 2),  # launched before the window: not counted
        *_launched(2, 5, 5, 15), *_launched(3, 25, 25, 40), *_launched(4, 42, 42, 48),
        *_launched(5, 52, 52, 58), *_launched(6, 61, 61, 79),
        *_launched(7, 85, 85, 99), *_launched(8, 105, 105, 108),
    ]


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_training_readers_divide_by_steps(steps):
    got = _read("olmoe-train-s4096", _trace(training_events()),
                {"window_s": 0.1, "steps": steps, "batch": 1, "seq_len": 4096}, TRAIN)
    assert got["train.forward_ms"] == pytest.approx((10 + 6) / steps)
    assert got["train.backward_ms"] == pytest.approx((15 + 18) / steps)
    assert got["train.optimizer_ms"] == pytest.approx((6 + 14) / steps)


def test_readers_read_nothing_without_the_program_spans():
    """A program without the spans (the parent of this benchmark's
    readers) leaves the metrics out and raises nothing."""
    tr = _trace([_span(trace.WINDOW_SPAN, 0, 100), *_launched(1, 5, 5, 15)])
    counts = {"window_s": 0.1, "steps": 2, "batch": 1, "seq_len": 4096}
    assert all(v is None for k, v in _read("yi-serve-docs-c64", tr, counts, SERVE).items()
               if k in SERVE)
    assert all(v is None for k, v in _read("olmoe-train-s4096", tr, counts, TRAIN).items()
               if k in TRAIN)
    counts["steps"] = 0
    got = _read("olmoe-train-s4096", _trace(training_events()), counts, TRAIN)
    assert all(got[k] is None for k in TRAIN)


def test_interval_arithmetic():
    a = [(0, 10), (20, 30)]
    b = [(-5, 2), (5, 7), (9, 22), (29, 40)]
    assert spans.minus(a, b) == [(2, 5), (7, 9), (22, 29)]
    assert spans.overlap(a, b) == 2 + 2 + 1 + 2 + 1
    assert spans.overlap(a, b) + sum(e - s for s, e in spans.minus(a, b)) == 20
    assert spans.merged([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]
