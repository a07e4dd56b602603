"""The port's live telemetry (``repro_torch.cluster.telemetry``): bus,
endpoint, traces.

Mirrors the tests of ``tests/test_telemetry.py`` that need no warm service
(its service-backed cases wait for the service's port): registry units
against an injected clock (deterministic Prometheus golden output,
ring/cursor semantics, histograms, the JSONL trace), membership transition
stamps, the HTTP endpoint and its event stream, and a ``backend="cluster"``
run serving ``/metrics`` (``http_port=``) whose final snapshot agrees with
the host's own counters.  Everything stays on 127.0.0.1 with stdlib HTTP
only.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from repro_torch.cluster.deploy.inprocess import InProcessLauncher
from repro_torch.cluster.membership import Membership
from repro_torch.cluster.telemetry import (
    Telemetry,
    TelemetryServer,
    TraceWriter,
    read_trace,
)
from repro_torch.core.builder import ClusterBuilder
from repro_torch.core.dsl import ClusterSpec
from repro_torch.core.processes import EmitDetails, ResultDetails

FAST = dict(heartbeat_interval=0.1, heartbeat_misses=4)


def _range_emit(n):
    return EmitDetails(
        name="range",
        init=lambda limit: (0, limit),
        init_data=(n,),
        create=lambda s: (None, s) if s[0] >= s[1] else (s[0], (s[0] + 1, s[1])),
    )


def _list_collect():
    return ResultDetails(name="list", init=lambda: [],
                         collect=lambda a, x: a + [x], finalise=sorted)


def _spec(work, n_items, *, nclusters=2, workers=2):
    return ClusterSpec.simple(
        host="127.0.0.1", nclusters=nclusters, workers_per_node=workers,
        emit_details=_range_emit(n_items), work_function=work,
        result_details=_list_collect(),
    )


def _double(x):
    return x * 2


def _triple(x):
    return x * 3


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read()


def _get_json(url):
    status, ctype, body = _get(url)
    assert status == 200
    assert ctype.startswith("application/json")
    return json.loads(body)


# ---------------------------------------------------------------------------
# registry units
# ---------------------------------------------------------------------------


def test_event_ring_ordering_and_since_cursor():
    t = Telemetry(ring_size=8, clock=lambda: 1000.0)
    for i in range(5):
        t.emit("step", n=i)
    events = t.events_since(0)
    assert [e["seq"] for e in events] == [1, 2, 3, 4, 5]
    assert [e["n"] for e in events] == [0, 1, 2, 3, 4]
    # The cursor contract: pass the largest seq seen, get only what's new.
    cursor = events[-1]["seq"]
    assert t.events_since(cursor) == []
    t.emit("step", n=5)
    newer = t.events_since(cursor)
    assert [e["seq"] for e in newer] == [6]
    # limit truncates from the oldest end.
    assert [e["seq"] for e in t.events_since(0, limit=2)] == [1, 2]


def test_event_ring_bounded_and_drop_accounted():
    t = Telemetry(ring_size=4, clock=lambda: 0.0)
    for i in range(10):
        t.emit("e", n=i)
    events = t.events_since(0)
    # Only the newest ring_size survive, in order, seq still monotonic.
    assert [e["seq"] for e in events] == [7, 8, 9, 10]
    snap = t.snapshot()
    assert snap["events"]["next"] == 10
    assert snap["events"]["dropped"] == 6


def test_emit_is_thread_safe_seq_unique():
    t = Telemetry(ring_size=4096)
    threads = [threading.Thread(
        target=lambda: [t.emit("x") for _ in range(200)])
        for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    seqs = [e["seq"] for e in t.events_since(0, limit=1000)]
    assert len(seqs) == 800
    assert seqs == sorted(seqs) and len(set(seqs)) == 800


def test_snapshot_merges_push_and_pull():
    t = Telemetry(clock=lambda: 50.0)
    t.set_node("node0", state="loaded", report={"boot_ms": 3.0})
    t.set_job(1, pending=[2], items_collected=7)
    t.inc("jobs_completed")
    # Samplers merge at snapshot time; node dicts merge one level deep so
    # sampled fields join the pushed report instead of replacing it.
    t.set_sampler("nodes", lambda: {
        "node0": {"credits": 4, "wire": {"bytes_sent": 100, "bytes_recv": 40}},
    })
    t.set_sampler("cluster", lambda: {"nodes_alive": 1})
    snap = t.snapshot()
    n = snap["nodes"]["node0"]
    assert n["state"] == "loaded" and n["credits"] == 4
    assert n["report"] == {"boot_ms": 3.0}
    assert snap["cluster"]["jobs_completed"] == 1
    assert snap["cluster"]["nodes_alive"] == 1
    # Cluster-wide wire totals are summed from the per-node wire dicts.
    assert snap["cluster"]["wire_bytes_sent"] == 100
    assert snap["jobs"]["1"]["items_collected"] == 7
    with pytest.raises(ValueError):
        t.set_sampler("bogus", dict)


def test_broken_sampler_never_breaks_snapshot():
    t = Telemetry()

    def exploding():
        raise RuntimeError("sampler bug")

    t.set_sampler("nodes", exploding)
    assert t.snapshot()["nodes"] == {}


def test_prometheus_golden():
    """Deterministic exposition: fixed clock, sorted families and labels."""
    clk = [100.0]
    t = Telemetry(clock=lambda: clk[0])
    clk[0] = 102.5
    t.inc("jobs_completed", 2)
    t.set_job(1, pending=[3, 1], items_collected=5, done=False)
    t.set_node("node0", state="loaded",
               report={"cache_hits": 2, "cache_misses": 1},
               wire={"bytes_sent": 10})
    got = t.prometheus()
    expected = "\n".join([
        "# TYPE repro_cluster_jobs_completed gauge",
        "repro_cluster_jobs_completed 2",
        "# TYPE repro_cluster_wire_bytes_sent gauge",
        "repro_cluster_wire_bytes_sent 10",
        "# TYPE repro_job_done gauge",
        'repro_job_done{job="1"} 0',
        "# TYPE repro_job_items_collected gauge",
        'repro_job_items_collected{job="1"} 5',
        "# TYPE repro_job_pending gauge",
        'repro_job_pending{job="1",stage="0"} 3',
        'repro_job_pending{job="1",stage="1"} 1',
        "# TYPE repro_node_report_cache_hits gauge",
        'repro_node_report_cache_hits{node="node0"} 2',
        "# TYPE repro_node_report_cache_misses gauge",
        'repro_node_report_cache_misses{node="node0"} 1',
        "# TYPE repro_node_state gauge",
        'repro_node_state{node="node0",state="loaded"} 1',
        "# TYPE repro_node_wire_bytes_sent gauge",
        'repro_node_wire_bytes_sent{node="node0"} 10',
        "# TYPE repro_uptime_seconds gauge",
        "repro_uptime_seconds 2.5",
    ]) + "\n"
    assert got == expected


def test_histogram_buckets_cumulate_and_expose():
    t = Telemetry(clock=lambda: 0.0)
    assert "histograms" not in t.snapshot()  # absent until first observe
    for v in (1, 2, 3, 5, 300):  # 300 overflows the largest bound (256)
        t.observe("result_batch_items", v)
    h = t.snapshot()["histograms"]["result_batch_items"]
    assert h["count"] == 5 and h["sum"] == 311
    cum = dict((le, n) for le, n in h["buckets"])
    # cumulative ``le`` semantics: <=1 is 1 obs; <=2 is 2; <=4 adds the 3;
    # <=8 adds the 5; the 300 only shows up in +Inf (count).
    assert cum[1.0] == 1 and cum[2.0] == 2 and cum[4.0] == 3
    assert cum[8.0] == 4 and cum[256.0] == 4
    prom = t.prometheus()
    assert "# TYPE repro_result_batch_items histogram" in prom
    assert 'repro_result_batch_items_bucket{le="4"} 3' in prom
    assert 'repro_result_batch_items_bucket{le="+Inf"} 5' in prom
    assert "repro_result_batch_items_sum 311" in prom
    assert "repro_result_batch_items_count 5" in prom


def test_histogram_unknown_family_gets_default_grid():
    t = Telemetry(clock=lambda: 0.0)
    t.observe("made_up_metric", 0.05)
    h = t.snapshot()["histograms"]["made_up_metric"]
    assert h["buckets"][0] == [0.1, 1]  # default grid starts at 0.1


def test_trace_jsonl_round_trip(tmp_path):
    path = str(tmp_path / "run.jsonl")
    t = Telemetry(trace_path=path, clock=lambda: 7.0)
    t.emit("job_submit", job=1)
    t.emit("job_done", job=1, items=3)
    t.close()
    events = read_trace(path)
    assert [e["kind"] for e in events] == ["job_submit", "job_done"]
    assert events[0]["seq"] == 1 and events[1]["items"] == 3
    # Append mode: a second run on the same path extends, never truncates.
    w = TraceWriter(path)
    w.write({"seq": 99, "kind": "extra"})
    w.close()
    w.close()  # idempotent
    assert [e["kind"] for e in read_trace(path)][-1] == "extra"


# ---------------------------------------------------------------------------
# membership transition timestamps
# ---------------------------------------------------------------------------


def test_membership_transitions_timestamped():
    m = Membership()
    seen = []
    m.on_transition = lambda rec, old: seen.append((rec.node_id, old,
                                                    rec.state))
    m.expect("n0", now=1.0)
    m.register("n0", "127.0.0.1:1", now=2.0)
    m.mark_loaded("n0")
    m.mark_done("n0")
    rec = m.nodes["n0"]
    states = [s for s, _ in rec.transitions]
    assert states == ["launching", "registered", "loaded", "done"]
    times = [at for _, at in rec.transitions]
    assert times == sorted(times) and rec.state_changed_at == times[-1]
    assert rec.transitions[1] == ("registered", 2.0)
    # expect() stamps the record directly; the hook fires on real changes.
    assert [old for _, old, _ in seen] == ["launching", "registered",
                                          "loaded"]
    assert "in-state" in m.describe()


# ---------------------------------------------------------------------------
# the HTTP endpoint (unit: handcrafted registry)
# ---------------------------------------------------------------------------


def test_endpoint_routes_and_error_paths():
    t = Telemetry(clock=lambda: 10.0)
    t.set_job(1, items_collected=2)
    t.set_node("node0", state="loaded")
    t.emit("e1")
    t.emit("e2")
    srv = TelemetryServer(t, port=0)
    try:
        status, ctype, body = _get(srv.url + "/")
        assert status == 200 and ctype.startswith("text/html")
        assert b"cluster telemetry" in body

        snap = _get_json(srv.url + "/metrics")
        assert snap["jobs"]["1"]["items_collected"] == 2
        assert _get_json(srv.url + "/jobs") == {"jobs": snap["jobs"]}
        assert _get_json(srv.url + "/nodes") == {"nodes": snap["nodes"]}

        status, ctype, body = _get(srv.url + "/metrics?format=prom")
        assert status == 200 and "0.0.4" in ctype
        assert b"# TYPE repro_uptime_seconds gauge" in body

        ev = _get_json(srv.url + "/events?since=0")
        assert [e["kind"] for e in ev["events"]] == ["e1", "e2"]
        assert ev["next"] == 2
        ev2 = _get_json(srv.url + "/events?since=2")
        assert ev2 == {"events": [], "next": 2}

        for bad, code in (("/nope", 404), ("/events?since=x", 400),
                          ("/metrics?format=xml", 400)):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _get(srv.url + bad)
            assert exc.value.code == code
    finally:
        srv.close()
        srv.close()  # idempotent


# ---------------------------------------------------------------------------
# integration: a one-shot cluster run
# ---------------------------------------------------------------------------


def test_one_shot_cluster_app_serves_metrics():
    """backend="cluster" observability: ProcessClusterApplication serves
    the endpoint during the run, and its final snapshot agrees with the
    host's counters and the nodes' items."""
    app = ClusterBuilder().build_application(
        _spec(_double, 20), backend="cluster",
        launcher=InProcessLauncher(), http_port=0, **FAST,
    )
    app.start()
    try:
        url = app.http_url
        assert url is not None
        snap = _get_json(url + "/metrics")
        assert snap["cluster"]["nodes_total"] == 2
        assert app.run() == [2 * i for i in range(20)]
    finally:
        pass  # run() already shut the cluster down
    final = app.metrics_snapshot()
    assert final["cluster"]["items_total"] == 20
    assert final["jobs"]["1"]["done"] is True
    assert final["jobs"]["1"]["items_collected"] == 20
    assert sum(n["items"] for n in final["nodes"].values()) == 20
    assert {n["state"] for n in final["nodes"].values()} == {"done"}
    kinds = [e["kind"] for e in app.telemetry.events_since(0, limit=500)]
    assert kinds.count("job_submit") == 1 and kinds.count("job_done") == 1
    assert "membership" in kinds
    assert app.orphaned() == []
    # the endpoint went with the run
    with pytest.raises(urllib.error.URLError):
        _get(url + "/metrics", timeout=1.0)


def test_cluster_app_without_http_port_serves_nothing():
    app = ClusterBuilder().build_application(
        _spec(_triple, 10), backend="cluster",
        launcher=InProcessLauncher(), **FAST,
    )
    assert app.run() == [3 * i for i in range(10)]
    assert app.http_url is None
    assert app.metrics_snapshot()["cluster"]["items_total"] == 10
    assert app.orphaned() == []


def test_sse_stream_pushes_snapshots_and_bus_events():
    """/events/stream: a snapshot frame arrives up front, emitted bus
    events are pushed without polling, and close() ends the stream rather
    than hanging on the open connection."""
    import http.client

    telem = Telemetry()
    telem.inc("nodes_alive", 2)
    server = TelemetryServer(telem)
    conn = http.client.HTTPConnection(server.host, server.port, timeout=5.0)
    try:
        conn.request("GET", "/events/stream")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "text/event-stream"

        def read_frame():
            lines = []
            while True:
                line = resp.fp.readline().decode("utf-8").rstrip("\n")
                if not line:
                    if lines:
                        return lines
                    continue
                lines.append(line)

        first = read_frame()
        assert first[0] == "event: snapshot"
        snap = json.loads(first[1][len("data: "):])
        assert snap["cluster"]["nodes_alive"] == 2

        telem.emit("node_registered", node="node7")
        deadline = time.monotonic() + 5
        kinds = []
        while time.monotonic() < deadline:
            frame = read_frame()
            if frame[0] == "event: bus":
                ev = json.loads(frame[1][len("data: "):])
                kinds.append(ev["kind"])
                if "node_registered" in kinds:
                    break
        assert "node_registered" in kinds
    finally:
        server.close()  # must not hang on the live stream
        conn.close()


def test_sse_stream_rejects_bad_cursor():
    telem = Telemetry()
    server = TelemetryServer(telem)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                f"{server.url}/events/stream?since=x", timeout=5.0)
        assert err.value.code == 400
    finally:
        server.close()
