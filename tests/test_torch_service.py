"""The port's persistent warm node pool (``repro_torch.cluster.service``).

Mirrors the 14 tests of ``tests/test_service.py``: one pool, many jobs —
concurrent submissions interleaving on the same nodes with exactly-once
preserved per job (including through a mid-run node death), warm
resubmission skipping both boot and code shipping, FIFO-with-priority
admission, failure isolation between jobs, the ``backend="service"``
builder path, grow / graceful shrink, and the per-stage prefetch cap on a
shared pool.  Each job's result is held against the same job run by the
JAX package (its threads backend, or its own ``ClusterService`` where the
case counts what the pool shipped).  Node-loaders run as threads over real
localhost sockets (``InProcessLauncher``).

Three cases follow that the port adds: ``close()`` collects every node's
timing record (the JAX package's service can lose one), the port
quickstart's ``service`` mode on the CPU (real node-loader subprocesses)
gives the JAX quickstart's counts, and a job whose work function names a
card the pool does not have fails alone, leaving the warm pool exact for
the next job on the CPU.
"""

import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro.cluster.deploy.inprocess import InProcessLauncher as JaxInProcess
from repro.cluster.service import ClusterService as JaxService
from repro.core import builder as jax_builder
from repro.core import dsl as jax_dsl
from repro.core import processes as jax_proc
from repro_torch import quickstart as port_qs
from repro_torch.cluster.deploy.inprocess import InProcessLauncher
from repro_torch.cluster.deploy.local import SRC_DIR
from repro_torch.cluster.service import ClusterService
from repro_torch.core.builder import ClusterBuilder
from repro_torch.core.dsl import ClusterSpec
from repro_torch.core.processes import EmitDetails, ResultDetails
from repro_torch.runtime.failures import WorkFunctionError

ROOT = Path(__file__).resolve().parents[1]
# Fast liveness settings (death detected within ~0.4s), for the case that
# kills a node.
FAST = dict(heartbeat_interval=0.1, heartbeat_misses=4)
# Every other case asserts results, counts or the kind of a failure, never
# a death: 10 s of silence, so a node a loaded machine holds off the
# interpreter is not declared dead.
SLACK = dict(heartbeat_interval=0.5, heartbeat_misses=20)
# The JAX quickstart's instance and its four counts on either backend.
WIDTH, LINES, ITERS = 300, 32, 100
JAX_COUNTS = (9600, 9308, 292, 69660)


def _create(s):
    return (None, s) if s[0] >= s[1] else (s[0], (s[0] + 1, s[1]))


def _range_emit(n):
    return EmitDetails(name="range", init=lambda limit: (0, limit),
                       init_data=(n,), create=_create)


def _list_collect():
    return ResultDetails(name="list", init=lambda: [],
                         collect=lambda a, x: a + [x], finalise=sorted)


def _spec(work, n_items, *, nclusters=2, workers=2):
    return ClusterSpec.simple(
        host="127.0.0.1", nclusters=nclusters, workers_per_node=workers,
        emit_details=_range_emit(n_items), work_function=work,
        result_details=_list_collect(),
    )


def _jax_spec(work, n_items, *, nclusters=2, workers=2):
    return jax_dsl.ClusterSpec.simple(
        host="127.0.0.1", nclusters=nclusters, workers_per_node=workers,
        emit_details=jax_proc.EmitDetails(
            name="range", init=lambda limit: (0, limit), init_data=(n_items,),
            create=_create),
        work_function=work,
        result_details=jax_proc.ResultDetails(
            name="list", init=lambda: [], collect=lambda a, x: a + [x],
            finalise=sorted),
    )


def _jax_result(work, n_items):
    """The same job on the JAX package's threads backend."""
    return jax_builder.ClusterBuilder().build_application(
        _jax_spec(work, n_items)).run()


def _service(liveness=SLACK, **kw):
    kw.setdefault("nodes", 2)
    kw.setdefault("workers", 2)
    kw.setdefault("launcher", InProcessLauncher())
    kw.update(liveness)
    return ClusterService(**kw)


def _jax_service(**kw):
    kw.setdefault("nodes", 2)
    kw.setdefault("workers", 2)
    return JaxService(launcher=JaxInProcess(), **kw, **SLACK)


# Module-level work functions: the same object on every submit, so their
# pickled digests match and resubmits hit the nodes' code caches.
def _double(x):
    return x * 2


def _triple(x):
    return x * 3


# ---------------------------------------------------------------------------
# one pool, many jobs
# ---------------------------------------------------------------------------


def test_back_to_back_jobs_one_pool():
    """Sequential submits reuse the booted pool: only the first submission
    is charged boot time, and both produce exact results."""
    with _service() as svc:
        h1 = svc.submit(_spec(_double, 30), timeout=60)
        assert h1.result() == _jax_result(_double, 30)
        h2 = svc.submit(_spec(_triple, 30), timeout=60)
        assert h2.result() == _jax_result(_triple, 30)
        assert h1.cluster_boot_ms > 0.0
        assert h2.cluster_boot_ms == 0.0
    assert svc.orphaned() == []


def test_concurrent_jobs_interleave_exactly_once():
    """Two jobs submitted together share the node pool; each collects its
    own items exactly once (no cross-job leakage, no loss, no dupes)."""
    with _service() as svc:
        h1 = svc.submit(_spec(_double, 40), timeout=60)
        h2 = svc.submit(_spec(_triple, 40), timeout=60)
        r1, r2 = h1.result(), h2.result()
        assert r1 == _jax_result(_double, 40) == [2 * i for i in range(40)]
        assert r2 == _jax_result(_triple, 40) == [3 * i for i in range(40)]
        assert h1.stats()["items_collected"] == 40
        assert h2.stats()["items_collected"] == 40
    assert svc.orphaned() == []


def test_node_death_mid_run_both_jobs_complete():
    """A node dying with in-flight items of *both* jobs: the host reaps it,
    requeues per job, and the surviving node finishes both exactly-once."""

    def slow_double(x):
        time.sleep(0.005)
        return x * 2

    def slow_triple(x):
        time.sleep(0.005)
        return x * 3

    n = 60
    with _service(FAST) as svc:
        h1 = svc.submit(_spec(slow_double, n), timeout=120)
        h2 = svc.submit(_spec(slow_triple, n), timeout=120)
        hl = svc.host_loader
        deadline = time.monotonic() + 30
        while hl.stats.items_total < 10:  # both jobs under way
            assert time.monotonic() < deadline
            time.sleep(0.005)
        svc.kill_node("node1")
        assert h1.result() == _jax_result(_double, n)
        assert h2.result() == _jax_result(_triple, n)
        assert hl.stats.deaths_detected == 1
        assert hl.stats.redispatched > 0
    assert svc.orphaned() == []


def test_priority_preempts_fifo():
    """A high-priority job submitted behind a long low-priority one is
    answered first at every demand: it finishes while the long job is
    still running."""

    def slow(x):
        time.sleep(0.01)
        return x

    with _service(nodes=1, workers=1) as svc:
        h_low = svc.submit(_spec(slow, 100, nclusters=1, workers=1),
                           priority=0, timeout=120)
        h_high = svc.submit(_spec(_double, 5, nclusters=1, workers=1),
                            priority=5, timeout=120)
        assert h_high.result() == _jax_result(_double, 5)
        assert not h_low.done()  # the long job is still going
        assert h_low.result() == _jax_result(lambda x: x, 100)
    assert svc.orphaned() == []


# ---------------------------------------------------------------------------
# warm resubmission
# ---------------------------------------------------------------------------


def test_warm_resubmit_skips_boot_and_code():
    """Resubmitting a pipeline whose stage function the nodes already hold:
    no boot, no code shipped — the nodes rebind from their digest cache.
    The code counts equal those of the JAX package's pool."""
    counts = {}
    for name, make_service, make_spec in (
            ("port", _service, _spec), ("jax", _jax_service, _jax_spec)):
        with make_service() as svc:
            h1 = svc.submit(make_spec(_double, 20), timeout=60)
            h1.result()
            s1 = h1.stats()
            assert s1["code_shipped"] > 0 and s1["code_cached"] == 0

            h2 = svc.submit(make_spec(_double, 20), timeout=60)
            assert h2.result() == h1.result() == _jax_result(_double, 20)
            s2 = h2.stats()
            assert s2["cluster_boot_ms"] == 0.0
            assert s2["code_shipped"] == 0  # every node served it from cache
            assert s2["code_cached"] == s1["code_shipped"]
            assert h2.submit_to_first_result_ms is not None
            counts[name] = (s1["code_shipped"], s1["code_cached"],
                            s2["code_shipped"], s2["code_cached"])
    assert counts["port"] == counts["jax"]


def test_failed_job_does_not_poison_the_pool():
    """A work-function error fails *that* job only; the pool stays warm and
    the next submission runs normally."""

    def cursed(x):
        if x == 7:
            raise ValueError("item 7 is cursed")
        return x

    with _service() as svc:
        h_bad = svc.submit(_spec(cursed, 20), timeout=60)
        with pytest.raises(WorkFunctionError, match="item 7 is cursed"):
            h_bad.result()
        h_ok = svc.submit(_spec(_double, 20), timeout=60)
        assert h_ok.result() == _jax_result(_double, 20)
    assert svc.orphaned() == []


def test_submit_after_close_rejected():
    svc = _service()
    svc.start()
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(_spec(_double, 5))


# ---------------------------------------------------------------------------
# builder integration (backend="service")
# ---------------------------------------------------------------------------


def test_builder_service_backend_ephemeral_pool():
    """backend="service" with no service= boots an ephemeral pool sized
    from the spec and tears it down after — the one-shot contract."""
    app = ClusterBuilder().build_application(
        _spec(_double, 25), backend="service",
        launcher=InProcessLauncher(), **SLACK,
    )
    assert app.run() == _jax_result(_double, 25)
    assert app.orphaned() == []


def test_builder_service_backend_shared_warm_pool():
    """Two applications over one caller-owned service: the second build of
    the same spec is a warm resubmit (no boot, no code shipped)."""
    with _service() as svc:
        b = ClusterBuilder()
        app1 = b.build_application(_spec(_triple, 15), backend="service",
                                   service=svc)
        app2 = b.build_application(_spec(_triple, 15), backend="service",
                                   service=svc)
        assert app1.run() == _jax_result(_triple, 15)
        assert app2.run() == app1.result
        assert app2.handle.cluster_boot_ms == 0.0
        assert app2.handle.stats()["code_shipped"] == 0
        # the shared pool survives its applications
        assert svc.run(_spec(_double, 5)) == [0, 2, 4, 6, 8]
    assert svc.orphaned() == []


# ---------------------------------------------------------------------------
# elasticity (grow / graceful shrink)
# ---------------------------------------------------------------------------


def _wait_pool(svc, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(svc.pool_alive()) == n:
            return
        time.sleep(0.05)
    raise AssertionError(f"pool never reached {n}: {svc.pool_alive()}")


def test_grow_adds_nodes_via_late_join():
    """grow() launches fresh node-loaders into the running pool: they
    register mid-run, receive the pool config, and serve work."""
    with _service(nodes=1) as svc:
        assert svc.run(_spec(_double, 10)) == _jax_result(_double, 10)
        new_ids = svc.grow(1)
        assert new_ids == ["node1"]
        _wait_pool(svc, 2)
        h = svc.submit(_spec(_double, 40), timeout=60)
        assert h.result() == _jax_result(_double, 40)
        assert svc.pool_alive() == ["node0", "node1"]
        assert svc.telemetry.snapshot()["cluster"]["scale_up_events"] == 1
    assert svc.orphaned() == []


def test_shrink_retires_node_gracefully():
    """shrink() fences the victim and UTs it: the pool contracts without a
    death event, and jobs keep producing exact results before and after."""
    with _service(nodes=2) as svc:
        assert svc.run(_spec(_double, 10)) == _jax_result(_double, 10)
        retired = svc.shrink()
        assert retired == "node1"
        _wait_pool(svc, 1)
        assert svc.run(_spec(_double, 20)) == _jax_result(_double, 20)
        snap = svc.telemetry.snapshot()["cluster"]
        assert snap["scale_down_events"] == 1
        assert svc.host_loader.membership.failures == []  # no death, a retire
        # The last live node is never retirable.
        assert svc.shrink() is None
    assert svc.orphaned() == []


def test_grow_then_shrink_round_trip():
    with _service(nodes=1) as svc:
        svc.start()
        svc.grow(1)
        _wait_pool(svc, 2)
        assert svc.shrink() == "node1"
        _wait_pool(svc, 1)
        assert svc.run(_spec(_triple, 12)) == _jax_result(_triple, 12)
    assert svc.orphaned() == []


def test_grow_launch_failure_retracts_announcement():
    """A launch that raises must not leave a phantom LAUNCHING record:
    the announcement is retracted, pool_span() stops counting it as
    capacity on its way, and no scale_up event is recorded."""
    with _service(nodes=1) as svc:
        assert svc.run(_spec(_double, 6)) == _jax_result(_double, 6)

        def boom(node_id, **kw):
            raise RuntimeError("launcher out of capacity")

        svc.launcher.launch = boom
        with pytest.raises(RuntimeError, match="out of capacity"):
            svc.grow(1)
        # Wait for the dispatcher to process both the announcement and
        # its retraction.
        deadline = time.monotonic() + 10
        while True:
            rec = svc.host_loader.membership.nodes.get("node1")
            if rec is not None and rec.state == "dead":
                break
            assert time.monotonic() < deadline, "retraction never applied"
            time.sleep(0.02)
        assert svc.pool_span() == (1, 0)
        snap = svc.telemetry.snapshot()["cluster"]
        assert snap.get("scale_up_events", 0) == 0
    assert svc.orphaned() == []


# ---------------------------------------------------------------------------
# per-stage data-plane knobs on the shared pool
# ---------------------------------------------------------------------------


def test_pool_job_honours_stage_prefetch_cap():
    """A service-pool job's per-stage prefetch= bounds how many of its
    items one node may hold: with prefetch=0 no WORK_BATCH can exceed the
    pool's worker count, where an uncapped job batches the full credit
    window."""
    from repro_torch.core.dsl import PipelineSpec, Stage

    def capped_spec(n):
        return PipelineSpec.simple(
            host="127.0.0.1", emit_details=_range_emit(n),
            stages=[Stage(name="double", fn=_double, nclusters=1,
                          workers_per_node=2, prefetch=0, flush_ms=1.0)],
            result_details=_list_collect(),
        )

    with _service(nodes=1, workers=2) as svc:
        h = svc.submit(capped_spec(40), timeout=60)
        assert h.result() == _jax_result(_double, 40)
        assert svc.host_loader.stats.max_batch <= 2  # pool_workers + 0
    assert svc.orphaned() == []


def test_close_collects_every_nodes_timing():
    """close() stops the dispatcher only once every node answered its UT,
    so each pool member's timing record reaches the pool's collector — a
    node grown into the pool after the job included.  (The JAX package's
    service stops it right after sending UT and keeps whichever records
    had arrived.)"""
    with _service(nodes=2) as svc:
        assert svc.run(_spec(_double, 40)) == _jax_result(_double, 40)
        svc.grow(1)
        deadline = time.monotonic() + 30
        while svc.host_loader.membership.nodes["node2"].state != "loaded":
            assert time.monotonic() < deadline
            time.sleep(0.01)
    records = {t.node_id: t for t in svc.timing.nodes if t.node_id != "host"}
    assert sorted(records) == ["node0", "node1", "node2"]
    assert sum(t.items for t in records.values()) == 40
    assert records["node2"].items == 0
    assert all(rec.state == "done"
               for rec in svc.host_loader.membership.nodes.values())
    assert svc.orphaned() == []


# ---------------------------------------------------------------------------
# the paper's job on a pool
# ---------------------------------------------------------------------------


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


def test_quickstart_service_mode_gives_the_jax_counts(jax_counts):
    """``python -m repro_torch.quickstart service --device cpu``: the
    paper's spec on a pool of 2 real node-loader subprocesses, booted for
    the run, prints the JAX quickstart's four counts."""
    env = dict(os.environ, PYTHONPATH=SRC_DIR)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.quickstart", "service",
         "--device", "cpu", "--width", str(WIDTH), "--lines", str(LINES),
         "--iters", str(ITERS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    expected = ", ".join(map(str, jax_counts))
    assert jax_counts == JAX_COUNTS
    assert expected in out.stdout.splitlines()


def test_card_job_failing_on_a_shared_pool_leaves_it_warm(monkeypatch,
                                                          jax_counts):
    """The paper's work function names its device.  On a warm pool whose
    nodes have no card, a job that names ``cuda`` fails with the node's
    error and never computes on the CPU; the next job, on the CPU, gets
    the JAX counts from the same pool with no boot."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _service(nodes=2, workers=4) as svc:
        svc.start()
        on_card = ClusterSpec.simple(
            host="127.0.0.1", nclusters=2, workers_per_node=4,
            emit_details=_range_emit(LINES),
            work_function=port_qs.Calculate(WIDTH, ITERS, "cuda"),
            result_details=_list_collect())
        failed = svc.submit(on_card, timeout=120)
        with pytest.raises(WorkFunctionError, match="no CUDA device"):
            failed.result(timeout=120)
        ok = svc.submit(port_qs.mandelbrot_spec(WIDTH, LINES, ITERS,
                                                device="cpu"), timeout=120)
        r = ok.result(timeout=120)
        assert (r["points"], r["white"], r["black"], r["total_iters"]) == \
            jax_counts
        assert ok.cluster_boot_ms == 0.0
        assert svc.pool_alive() == ["node0", "node1"]
    assert svc.orphaned() == []
