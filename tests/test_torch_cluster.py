"""The port's process transport (``repro_torch.cluster``), on localhost
sockets and the CPU.

Mirrors the 14 tests of ``tests/test_cluster.py``: wire format, socket
channels, membership thresholds, bootstrap across real subprocesses,
demand-driven distribution (straggler bias), node death mid-job with no
lost or duplicated work, and clean UT shutdown with no orphaned processes.
Real node-loader subprocesses run only where a case needs a real process
(bootstrap and clean exit, a SIGKILLed node, the paper's job checked
against the JAX package); the rest run their node-loaders as threads
(``InProcessLauncher``) over the same TCP protocol.

Work functions are defined inside the tests, so cloudpickle ships them by
value; the paper's work function (``repro_torch.quickstart.Calculate``)
ships through plain ``pickle`` by reference.
"""

import importlib.util
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro.core import builder as jax_builder
from repro.core import dsl as jax_dsl
from repro_torch import quickstart as port_qs
from repro_torch.cluster import wire as port_wire
from repro_torch.cluster.deploy.inprocess import InProcessLauncher
from repro_torch.cluster.deploy.local import SRC_DIR, _child_env, torch_node_env
from repro_torch.cluster.membership import DEAD, DONE, Membership
from repro_torch.cluster.netchannels import ChannelClosed, ChannelMux
from repro_torch.cluster.wire import (
    APP_WIRE_CHANNEL,
    LOAD_WIRE_CHANNEL,
    UT,
    Frame,
    FrameConnection,
    FrameType,
    pack_frame,
    unpack_frame,
)
from repro_torch.core.builder import ClusterBuilder
from repro_torch.core.dsl import ClusterSpec
from repro_torch.core.processes import EmitDetails, ResultDetails
from repro_torch.runtime.failures import HeartbeatMonitor, WorkFunctionError

ROOT = Path(__file__).resolve().parents[1]
# Fast liveness settings for tests (death detected within ~0.4s).
FAST = dict(heartbeat_interval=0.1, heartbeat_misses=4)
# Liveness for a case that asserts what kind of failure a job ends with, not
# that a death is detected: 10 s of silence, so a node a loaded machine holds
# off the interpreter is never declared dead before its error arrives.
SLACK = dict(heartbeat_interval=0.5, heartbeat_misses=20)
# The JAX quickstart's instance and its four counts (points, white, black,
# total iterations) on either of its backends.
WIDTH, LINES, ITERS = 300, 32, 100
JAX_COUNTS = (9600, 9308, 292, 69660)


def _range_emit(n):
    return EmitDetails(
        name="range",
        init=lambda limit: (0, limit),
        init_data=(n,),
        create=lambda s: (None, s) if s[0] >= s[1] else (s[0], (s[0] + 1, s[1])),
    )


def _sum_collect():
    return ResultDetails(name="sum", init=lambda: 0,
                         collect=lambda a, x: a + x)


def _spec(nclusters, workers, n_items, work):
    return ClusterSpec.simple(
        host="127.0.0.1", nclusters=nclusters, workers_per_node=workers,
        emit_details=_range_emit(n_items), work_function=work,
        result_details=_sum_collect(),
    )


def _threads_cluster(spec, builder=None, **options):
    """A ``backend="cluster"`` app whose node-loaders are threads."""
    return (builder or ClusterBuilder()).build_application(
        spec, backend="cluster", launcher=InProcessLauncher(),
        job_timeout=60.0, **{**FAST, **options})


# ---------------------------------------------------------------------------
# wire
# ---------------------------------------------------------------------------


def test_wire_frame_roundtrip_msgpack_and_pickle():
    f = Frame(FrameType.HEARTBEAT, {"node_id": "node0"}, LOAD_WIRE_CHANNEL)
    g = unpack_frame(pack_frame(f))
    assert g.ftype is FrameType.HEARTBEAT
    assert g.payload == {"node_id": "node0"}
    assert g.channel == LOAD_WIRE_CHANNEL

    f = Frame(FrameType.WORK, {"id": 3, "obj": (1, 2)}, APP_WIRE_CHANNEL)
    g = unpack_frame(pack_frame(f))
    assert g.payload["obj"] == (1, 2)
    assert isinstance(g.payload["obj"], tuple)

    f = Frame(FrameType.LOAD, {"function": lambda x: x + 41})
    g = unpack_frame(pack_frame(f))
    assert g.payload["function"](1) == 42

    g = unpack_frame(pack_frame(Frame(FrameType.RESULT, {"value": 2**70})))
    assert g.payload["value"] == 2**70

    g = unpack_frame(pack_frame(Frame(FrameType.UT, None)))
    assert g.ftype is FrameType.UT and g.payload is None


def test_wire_rejects_corrupt_header():
    raw = bytearray(pack_frame(Frame(FrameType.WORK_REQUEST, {"node_id": "n"})))
    raw[0:4] = b"XXXX"
    with pytest.raises(ValueError, match="magic"):
        unpack_frame(bytes(raw))


def test_netchannel_mux_blocking_roundtrip_and_close():
    a, b = socket.socketpair()
    left, right = FrameConnection(a), FrameConnection(b)
    mux_l, mux_r = ChannelMux(left), ChannelMux(right)
    ch_l = mux_l.open(APP_WIRE_CHANNEL, FrameType.WORK)
    ch_r = mux_r.open(APP_WIRE_CHANNEL, FrameType.WORK)
    mux_l.start()
    mux_r.start()

    ch_l.put({"id": 0, "obj": 7})
    assert ch_r.get(timeout=5) == {"id": 0, "obj": 7}
    ch_r.put(UT)
    assert ch_l.get(timeout=5) is UT

    mux_r.close()
    with pytest.raises(ChannelClosed):
        ch_l.get(timeout=5)
    mux_l.close()


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------


def test_membership_heartbeat_threshold_declares_death():
    m = Membership(HeartbeatMonitor(interval_s=0.1, misses=3))
    m.register("node0", "127.0.0.1:1", now=0.0)
    m.register("node1", "127.0.0.1:2", now=0.0)
    m.beat("node1", now=0.5)
    dead = m.reap(now=0.6, at_item=12)
    assert [r.node_id for r in dead] == ["node0"]
    assert m.nodes["node0"].state == DEAD
    assert m.nodes["node1"].alive
    ev = m.failures[0]
    assert ev.kind == "node_loss" and ev.node == 0 and ev.step == 12
    m.beat("node0", now=0.7)
    assert m.reap(now=0.8) == []
    m.mark_done("node1", {"items": 5})
    assert m.finished()


# ---------------------------------------------------------------------------
# real node-loader subprocesses
# ---------------------------------------------------------------------------


def test_cluster_backend_bootstraps_and_completes():
    """ClusterSpec -> backend="cluster" -> 2 real subprocesses -> exact
    result, per-node timing returned, clean UT shutdown, no orphans."""

    def work(x):
        return x * x

    builder = ClusterBuilder()
    app = builder.build_application(
        _spec(2, 2, 40, work), backend="cluster", job_timeout=120.0, **FAST
    )
    assert app.run() == sum(i * i for i in range(40))

    stats = app.host_loader.stats
    assert stats.items_total == 40
    assert stats.redispatched == 0 and stats.deaths_detected == 0

    assert len(app.processes) == 2
    assert all(isinstance(h.proc, subprocess.Popen) for h in app.processes.values())
    assert app.orphaned() == []
    assert all(p.returncode == 0 for p in app.processes.values())
    assert all(r.state == DONE
               for r in app.host_loader.membership.nodes.values())

    by_id = {t.node_id: t for t in builder.timing.nodes}
    assert {"host", "node0", "node1"} <= set(by_id)
    assert by_id["node0"].items + by_id["node1"].items == 40
    assert by_id["node0"].run_ms > 0 and by_id["node1"].run_ms > 0


def test_node_death_is_detected_and_work_redispatched():
    """SIGKILL one node-loader mid-job: missed heartbeats declare it dead,
    its in-flight items are re-dispatched, and the survivors finish with no
    item lost or duplicated (the sum is exact)."""

    def work(x):
        time.sleep(0.03)
        return 3 * x

    n_items = 60
    builder = ClusterBuilder()
    app = builder.build_application(
        _spec(3, 1, n_items, work), backend="cluster", job_timeout=120.0,
        **FAST
    )
    runner = app.run_async()
    while app.host_loader is None or app.host_loader.stats.items_total < 5:
        time.sleep(0.02)
        assert runner.is_alive()
    app.kill_node("node1")
    runner.join(timeout=120)
    assert not runner.is_alive(), "cluster hung after node death"

    assert app.result == sum(3 * i for i in range(n_items))
    hl = app.host_loader
    assert hl.stats.deaths_detected == 1
    assert hl.stats.items_total == n_items
    assert hl.stats.duplicates_dropped == 0
    [ev] = hl.membership.failures
    assert ev.kind == "node_loss"
    assert hl.membership.nodes["node1"].state == DEAD
    assert app.orphaned() == []
    assert app.processes["node0"].returncode == 0
    assert app.processes["node2"].returncode == 0
    assert app.processes["node1"].returncode != 0


@pytest.fixture(scope="module")
def jax_counts():
    """The JAX package's quickstart at WIDTH x LINES x ITERS, on threads."""
    knobs = {"QUICKSTART_WIDTH": str(WIDTH), "QUICKSTART_LINES": str(LINES),
             "QUICKSTART_ITERS": str(ITERS)}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in knobs.items():
            mp.setenv(k, v)
        spec = importlib.util.spec_from_file_location(
            "jax_quickstart", ROOT / "examples" / "quickstart.py")
        qs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(qs)
    jax_spec = jax_dsl.parse_cgpp(
        qs.SPEC % {"iters": ITERS, "width": WIDTH, "lines": LINES},
        namespace={"CALCULATE": qs.calculate, "COLLECTOR": qs.collector})
    r = jax_builder.ClusterBuilder().build_application(jax_spec).run()
    return r["points"], r["white"], r["black"], r["total_iters"]


def test_paper_job_on_subprocesses_equals_jax_through_plain_pickle(
        monkeypatch, jax_counts):
    """The paper's parsed spec over 2 real node-loaders x 4 workers, the
    work function shipped by plain pickle: the JAX quickstart's counts.

    Each node imports torch while it boots; on a machine busy with other
    work that can hold a node's heartbeat thread off the interpreter for
    seconds, so the liveness settings allow 30 s of silence (a death would
    show as a node with no items or a job error, never as wrong counts).

    A node's preload (its import of torch) can end seconds after the
    other's, and 32 plain lines take well under a second, so the node
    loaded first could drain the job alone.  Each item therefore holds its
    worker for ``per_item_s`` and a node holds at most one item per worker
    (``prefetch=0``): items stay queued for ``(LINES - workers) *
    per_item_s / workers`` = 10.5 s after the first node starts, so both
    nodes get items unless their preloads end more than 10.5 s apart.
    """
    monkeypatch.setattr(port_wire, "_pickler", pickle)
    per_item_s = 1.5
    builder = ClusterBuilder()
    app = builder.build_application(
        port_qs.mandelbrot_spec(WIDTH, LINES, ITERS, device="cpu"),
        backend="cluster", job_timeout=120.0, register_timeout=120.0,
        heartbeat_interval=0.5, heartbeat_misses=60, prefetch=0,
        slowdown={"node0": per_item_s, "node1": per_item_s},
        **port_qs.backend_options("cluster"))
    r = app.run()
    assert (r["points"], r["white"], r["black"], r["total_iters"]) == \
        jax_counts == JAX_COUNTS
    nodes = {t.node_id: t for t in builder.timing.nodes
             if t.node_id.startswith("node")}
    assert sorted(nodes) == ["node0", "node1"]
    assert sum(t.items for t in nodes.values()) == LINES
    assert all(t.items > 0 and t.boot_ms > 0 for t in nodes.values())
    assert app.orphaned() == []
    assert all(h.returncode == 0 for h in app.processes.values())


# ---------------------------------------------------------------------------
# node-loaders as threads: the same protocol without the process start
# ---------------------------------------------------------------------------


def test_demand_driven_distribution_biases_against_straggler():
    """An artificially slowed node must receive measurably fewer items — the
    onrl/nrfa protocol only answers *requests*, it never pushes."""

    def work(x):
        time.sleep(0.005)
        return x + 1

    builder = ClusterBuilder()
    app = _threads_cluster(_spec(2, 1, 40, work), builder,
                           slowdown={"node1": 0.05})
    assert app.run() == sum(i + 1 for i in range(40))
    items = {t.node_id: t.items for t in builder.timing.nodes
             if t.node_id.startswith("node")}
    assert items["node0"] + items["node1"] == 40
    assert items["node1"] < items["node0"], items
    assert items["node1"] <= 40 // 2 - 2, items
    assert app.orphaned() == []


def test_all_nodes_dead_raises_instead_of_hanging():
    def work(x):
        time.sleep(0.05)
        return x

    app = _threads_cluster(_spec(1, 1, 50, work))
    runner = app.run_async()
    while app.host_loader is None or app.host_loader.stats.items_total < 2:
        time.sleep(0.02)
        assert runner.is_alive()
    app.kill_node("node0")
    runner.join(timeout=60)
    assert not runner.is_alive()
    assert app.result is None
    assert isinstance(app.error, RuntimeError)
    assert "died with work outstanding" in str(app.error)


def test_work_function_exception_fails_job_with_node_traceback():
    def work(x):
        if x == 7:
            raise ValueError("item 7 is cursed")
        return x

    app = _threads_cluster(_spec(2, 1, 20, work))
    runner = app.run_async()
    runner.join(timeout=60)
    assert not runner.is_alive()
    assert app.result is None
    assert isinstance(app.error, WorkFunctionError)
    assert "item 7 is cursed" in str(app.error)
    assert app.orphaned() == []


def test_node_without_a_card_fails_the_job_instead_of_using_the_cpu(
        monkeypatch):
    """The paper's work function names its device; a node that has no card
    fails the job with its traceback and never computes on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ClusterSpec.simple(
        host="127.0.0.1", nclusters=1, workers_per_node=2,
        emit_details=_range_emit(4),
        work_function=port_qs.Calculate(WIDTH, ITERS, "cuda"),
        result_details=ResultDetails(name="c", init=lambda: 0,
                                     collect=lambda a, x: a + x["points"]))
    app = _threads_cluster(spec, **SLACK)
    runner = app.run_async()
    runner.join(timeout=60)
    assert not runner.is_alive()
    assert isinstance(app.error, WorkFunctionError)
    assert "no CUDA device" in str(app.error)


def test_pipelined_dispatch_batches_frames_and_counts_wire_traffic():
    def work(x):
        return x + 1

    n_items = 200
    builder = ClusterBuilder()
    app = _threads_cluster(_spec(2, 2, n_items, work), builder, flush_items=16)
    assert app.run() == sum(i + 1 for i in range(n_items))

    stats = app.host_loader.stats
    assert stats.items_total == n_items
    assert stats.work_batches < n_items
    assert stats.result_batches < n_items
    assert stats.max_batch > 1
    assert stats.work_requests == 2

    wire_counts = builder.timing.wire
    assert wire_counts["bytes_sent"] > 0 and wire_counts["bytes_recv"] > 0
    assert wire_counts["round_trips"] == (
        stats.work_requests + stats.result_batches
    )
    assert wire_counts["frames_recv"] < 2 * n_items

    by_id = {t.node_id: t for t in builder.timing.nodes}
    assert by_id["node0"].boot_ms >= 0.0
    assert by_id["node0"].load_ms > 0.0
    assert app.orphaned() == []


def test_prefetch_zero_gives_strict_per_worker_window():
    def work(x):
        return x * 2

    app = _threads_cluster(_spec(1, 2, 30, work), prefetch=0)
    assert app.run() == sum(2 * i for i in range(30))
    assert app.host_loader.stats.max_batch <= 2
    assert app.orphaned() == []


def test_unencodable_work_item_fails_job_instead_of_requeue_loop():
    deep = []
    for _ in range(100_000):
        deep = [deep]

    spec = ClusterSpec.simple(
        host="127.0.0.1", nclusters=1, workers_per_node=1,
        emit_details=EmitDetails(
            name="deep", init=lambda: 0, init_data=(),
            create=lambda s: (None, s) if s else (deep, 1),
        ),
        work_function=lambda x: 0,
        result_details=_sum_collect(),
    )
    app = _threads_cluster(spec)
    runner = app.run_async()
    runner.join(timeout=60)
    assert not runner.is_alive()
    assert isinstance(app.error, ValueError)
    assert "nested too deeply" in str(app.error)
    assert app.orphaned() == []


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="backend"):
        ClusterBuilder().build_application(
            _spec(1, 1, 1, lambda x: x), backend="mpi"
        )
    with pytest.raises(TypeError, match="options"):
        ClusterBuilder().build_application(
            _spec(1, 1, 1, lambda x: x), backend="threads", port=1234
        )


def test_same_spec_same_result_on_both_backends():
    """Zero user-code changes between threads and the transport (§6.1)."""

    def work(x):
        return (x, x * 2)  # tuple payload: exercises the pickle codec path

    def collect(acc, item):
        return acc + item[0] + item[1]

    def make():
        return ClusterSpec.simple(
            host="127.0.0.1", nclusters=2, workers_per_node=2,
            emit_details=_range_emit(30), work_function=work,
            result_details=ResultDetails(name="s", init=lambda: 0,
                                         collect=collect),
        )

    threaded = ClusterBuilder().build_application(make()).run()
    processed = _threads_cluster(make()).run()
    assert threaded == processed == sum(3 * i for i in range(30))


# ---------------------------------------------------------------------------
# what the port adds around the transport
# ---------------------------------------------------------------------------


def test_paper_work_function_ships_through_plain_pickle():
    """By reference, as ``repro_torch.quickstart.Calculate``: a node imports
    it, so no closure and no cloudpickle is needed."""
    fn = port_qs.make_calculate(WIDTH, ITERS, device="cpu")
    blob = pickle.dumps(fn)
    assert b"repro_torch.quickstart" in blob and b"Calculate" in blob
    back = port_wire.loads_code(blob)
    assert back == fn and back.device == "cpu"
    assert back(5) == fn(5)
    assert all(type(v) is int for v in back(5).values())


def test_node_env_puts_the_port_on_the_path():
    assert torch_node_env() == {"PYTHONPATH": SRC_DIR}
    assert (Path(SRC_DIR) / "repro_torch" / "__init__.py").exists()
    assert _child_env()["PYTHONPATH"].split(os.pathsep)[0] == SRC_DIR


@pytest.mark.parametrize("args,code,text", [
    ([], 2, "required"),
    (["--host", "127.0.0.1", "--port", "1", "--connect-timeout", "0.3"], 1,
     "cannot reach host-node-loader"),
], ids=["missing-arguments", "dead-port"])
def test_node_loader_cli(args, code, text):
    env = dict(os.environ, PYTHONPATH=SRC_DIR)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.cluster.node_loader", *args],
        env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == code
    assert text in out.stdout + out.stderr
    if code == 1:
        assert len(out.stdout.strip().splitlines()) == 1


def test_chaos_option_is_not_ported_yet():
    """``chaos=`` on the cluster backend, once left for a later slice, arms
    its fault plan over the one-shot run: the node it kills mid-job is
    reaped, its items are requeued and the result stays exact
    (``tests/test_torch_chaos.py`` holds the fault injector's own cases)."""
    from repro_torch.cluster.chaos import Fault, FaultPlan

    def work(x):
        time.sleep(0.01)
        return 3 * x

    plan = FaultPlan([Fault("kill_node", node="node1", after_items=5)])
    app = _threads_cluster(_spec(2, 1, 40, work), chaos=plan)
    assert app.run() == sum(3 * i for i in range(40))
    assert app.chaos_controller.injected == 1
    assert app.host_loader.stats.deaths_detected == 1
    assert app.host_loader.stats.items_total == 40
    assert app.orphaned() == []


def test_node_loader_bootstrap_imports_no_torch():
    """A node-loader starts as a bare bootstrap: torch arrives only with the
    shipped code or a ``--preload``."""
    probe = ("import sys, repro_torch.cluster.node_loader, "
             "repro_torch.cluster.spawn; print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=60,
                         env=dict(os.environ, PYTHONPATH=SRC_DIR))
    assert out.stdout.strip() == "False", out.stderr
