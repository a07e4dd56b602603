"""The port's job gateway (``repro_torch.cluster.gateway``): durable queue,
fairness, scaling.

Mirrors the 22 tests of ``tests/test_gateway.py``.  Scheduler and store
units are pure (injected clocks, ``tmp_path`` databases), and the
scheduler's admission orders are held equal to the JAX package's
``FairScheduler`` on the same queues.  The integration tests put a real
JobGateway in front of a ClusterService over an InProcessLauncher and
exercise the three pillars end-to-end: tickets that survive a gateway crash
(enqueue → kill → restart → attach → result), deficit-round-robin admission
that keeps a narrow tenant from starving behind a wide high-priority one,
and the queue-driven autoscaler growing and retiring pool nodes; every
job's result is held against the same job on the JAX package's threads
backend.  Everything stays on 127.0.0.1, and every database in ``tmp_path``.
"""

import time

import pytest

from repro.cluster import gateway as jax_gateway
from repro.core import builder as jax_builder
from repro.core import dsl as jax_dsl
from repro.core import processes as jax_proc
from repro_torch.cluster import gateway as port_gateway
from repro_torch.cluster.deploy.inprocess import InProcessLauncher
from repro_torch.cluster.gateway import (
    AutoscalePolicy,
    FairScheduler,
    JobCancelled,
    JobGateway,
    TenantPolicy,
    TicketStore,
)
from repro_torch.cluster.service import ClusterService
from repro_torch.core.dsl import ClusterSpec
from repro_torch.core.processes import EmitDetails, ResultDetails

# No case here asserts a death: 10 s of heartbeat silence, so a node a
# loaded machine holds off the interpreter is never declared dead.
SLACK = dict(heartbeat_interval=0.5, heartbeat_misses=20)


def _create(s):
    return (None, s) if s[0] >= s[1] else (s[0], (s[0] + 1, s[1]))


def _range_emit(n):
    return EmitDetails(name="range", init=lambda limit: (0, limit),
                       init_data=(n,), create=_create)


def _jax_result(work, n_items):
    """The same job on the JAX package's threads backend."""
    spec = jax_dsl.ClusterSpec.simple(
        host="127.0.0.1", nclusters=1, workers_per_node=2,
        emit_details=jax_proc.EmitDetails(
            name="range", init=lambda limit: (0, limit), init_data=(n_items,),
            create=_create),
        work_function=work,
        result_details=jax_proc.ResultDetails(
            name="list", init=lambda: [], collect=lambda a, x: a + [x],
            finalise=sorted),
    )
    return jax_builder.ClusterBuilder().build_application(spec).run()


def _list_collect():
    return ResultDetails(name="list", init=lambda: [],
                         collect=lambda a, x: a + [x], finalise=sorted)


def _spec(work, n_items, *, nclusters=1, workers=2):
    return ClusterSpec.simple(
        host="127.0.0.1", nclusters=nclusters, workers_per_node=workers,
        emit_details=_range_emit(n_items), work_function=work,
        result_details=_list_collect(),
    )


def _service(**kw):
    kw.setdefault("nodes", 1)
    kw.setdefault("workers", 2)
    kw.setdefault("launcher", InProcessLauncher())
    kw.update(SLACK)
    return ClusterService(**kw)


# Module-level work functions: stable cloudpickle digests across submits
# (warm code-cache hits) and across gateway restarts (recovered tickets
# resubmit the identical spec blob).
def _double(x):
    return x * 2


def _slow_double(x):
    time.sleep(0.02)
    return x * 2


def _entry(ticket, tenant, *, priority=0, submitted_at=0.0, timeout=None,
           g=port_gateway):
    return g.QueueEntry(ticket=ticket, tenant=tenant, priority=priority,
                        submitted_at=submitted_at, timeout=timeout)


def _same_on_jax(run):
    """``run(g)`` on the port's gateway package and on the JAX package's:
    the two must give the same answer, which is returned."""
    port, ref = run(port_gateway), run(jax_gateway)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# FairScheduler units (pure, injected clocks)
# ---------------------------------------------------------------------------


def test_drr_weights_give_proportional_admissions():
    """A weight-2 tenant is admitted twice per weight-1 admission while
    both have queued work."""
    def run(g):
        sched = g.FairScheduler({"big": g.TenantPolicy(weight=2.0),
                                 "small": g.TenantPolicy(weight=1.0)})
        for i in range(12):
            sched.push(_entry(f"b{i}", "big", g=g))
            sched.push(_entry(f"s{i}", "small", g=g))
        return [sched.pop_next(now=100.0).tenant for _ in range(9)]

    order = _same_on_jax(run)
    assert order.count("big") == 6
    assert order.count("small") == 3


def test_equal_weights_alternate():
    def run(g):
        sched = g.FairScheduler()
        for i in range(4):
            sched.push(_entry(f"a{i}", "a", g=g))
            sched.push(_entry(f"b{i}", "b", g=g))
        return [sched.pop_next(now=1.0).tenant for _ in range(6)]

    order = _same_on_jax(run)
    # Ties break to the least-recently-served: strict alternation.
    assert order[:2] in (["a", "b"], ["b", "a"])
    assert all(order[i] != order[i + 1] for i in range(5))


def test_priority_orders_within_tenant_only():
    """Submit priority ranks tickets inside one tenant; across tenants the
    weights decide, so tenant b still gets served between a's tickets."""
    def run(g):
        sched = g.FairScheduler()
        sched.push(_entry("a-low", "a", priority=0, g=g))
        sched.push(_entry("a-high", "a", priority=5, g=g))
        sched.push(_entry("b-low", "b", priority=0, g=g))
        return [sched.pop_next(now=1.0).ticket for _ in range(3)]

    picks = _same_on_jax(run)
    # Within tenant a the high-priority ticket leads; b is interleaved,
    # not starved behind both of a's.
    assert picks.index("a-high") < picks.index("a-low")
    assert picks.index("b-low") < 2


def test_aging_lifts_stale_tickets_past_fresh_high_priority():
    sched = FairScheduler(aging_s=10.0)
    sched.push(_entry("old", "t", priority=0, submitted_at=0.0))
    sched.push(_entry("new", "t", priority=3, submitted_at=100.0))
    # At t=100 the old ticket has aged +10 effective priority: it wins.
    assert sched.pop_next(now=100.0).ticket == "old"
    # Without the age advantage the fresher high-priority one would have:
    sched2 = FairScheduler(aging_s=10.0)
    sched2.push(_entry("old", "t", priority=0, submitted_at=99.0))
    sched2.push(_entry("new", "t", priority=3, submitted_at=100.0))
    assert sched2.pop_next(now=100.0).ticket == "new"


def test_fifo_mode_is_strict_priority_across_tenants():
    def run(g):
        sched = g.FairScheduler(mode="fifo")
        sched.push(_entry("a1", "a", priority=0, submitted_at=1.0, g=g))
        sched.push(_entry("b1", "b", priority=5, submitted_at=2.0, g=g))
        sched.push(_entry("b2", "b", priority=5, submitted_at=3.0, g=g))
        return [sched.pop_next(now=4.0).ticket for _ in range(3)]

    picks = _same_on_jax(run)
    assert picks == ["b1", "b2", "a1"]  # the starvation baseline


def test_max_active_jobs_cap_blocks_tenant():
    sched = FairScheduler({"capped": TenantPolicy(max_active_jobs=1)})
    sched.push(_entry("c1", "capped"))
    sched.push(_entry("u1", "uncapped"))
    # capped already has 1 admitted job: only the other tenant is eligible.
    assert sched.pop_next({"capped": 1}, now=1.0).ticket == "u1"
    assert sched.pop_next({"capped": 1}, now=1.0) is None
    assert sched.pop_next({}, now=1.0).ticket == "c1"


def test_remove_and_drop_expired():
    sched = FairScheduler()
    sched.push(_entry("keep", "t", submitted_at=0.0))
    sched.push(_entry("gone", "t", submitted_at=0.0, timeout=5.0))
    sched.push(_entry("fresh", "t", submitted_at=8.0, timeout=5.0))
    assert sched.remove("nope") is None
    expired = sched.drop_expired(now=6.0)
    assert [e.ticket for e in expired] == ["gone"]
    assert sched.remove("keep").ticket == "keep"
    assert sched.depth() == 1 and sched.oldest_wait(now=10.0) == 2.0


def test_scheduler_validation():
    with pytest.raises(ValueError):
        FairScheduler(mode="lifo")
    with pytest.raises(ValueError):
        FairScheduler({"t": TenantPolicy(weight=0.0)})
    with pytest.raises(ValueError):
        TenantPolicy(max_inflight=0).validate()


# ---------------------------------------------------------------------------
# TicketStore units (real files: durability is the point)
# ---------------------------------------------------------------------------


def test_store_lifecycle_and_reopen(tmp_path):
    db = str(tmp_path / "q.db")
    store = TicketStore(db)
    store.add("t1", {"payload": 1}, tenant="a", priority=2, retries=1,
              timeout=9.0)
    store.mark_running("t1")
    store.finish("t1", result=[1, 2, 3], summary={"cluster_boot_ms": 0.0})
    store.add("t2", {"payload": 2}, tenant="b", priority=0, retries=0,
              timeout=None)
    store.close()
    # A fresh process over the same file sees everything.
    store2 = TicketStore(db)
    row = store2.get("t1")
    assert row.state == "done"
    assert row.load_result() == [1, 2, 3]
    assert row.summary == {"cluster_boot_ms": 0.0}
    assert row.load_spec() == {"payload": 1}
    assert store2.counts() == {"done": 1, "queued": 1}
    store2.close()


def test_store_recover_requeues_running_rows(tmp_path):
    store = TicketStore(str(tmp_path / "q.db"))
    store.add("ran", {}, tenant="a", priority=0, retries=0, timeout=None,
              now=1.0)
    store.add("sat", {}, tenant="a", priority=0, retries=0, timeout=None,
              now=2.0)
    store.add("fin", {}, tenant="a", priority=0, retries=0, timeout=None)
    store.mark_running("ran")
    store.mark_running("fin")
    store.finish("fin", result="x")
    rows = store.recover()
    # The crashed-mid-run row is queued again (oldest first); done stays.
    assert [r.ticket for r in rows] == ["ran", "sat"]
    assert store.get("ran").state == "queued"
    assert store.get("ran").started_at is None
    assert store.get("fin").state == "done"
    store.close()


def test_store_cancel_only_from_queued(tmp_path):
    store = TicketStore(str(tmp_path / "q.db"))
    store.add("q", {}, tenant="a", priority=0, retries=0, timeout=None)
    store.add("r", {}, tenant="a", priority=0, retries=0, timeout=None)
    store.mark_running("r")
    assert store.cancel("q", "client asked") is True
    assert store.cancel("r", "client asked") is False
    assert store.get("q").state == "cancelled"
    assert store.get("q").error == "client asked"
    assert store.get("r").state == "running"
    store.close()


# ---------------------------------------------------------------------------
# Gateway end-to-end (real pool over InProcessLauncher)
# ---------------------------------------------------------------------------


def test_enqueue_attach_result_roundtrip(tmp_path):
    with _service() as svc:
        with JobGateway(svc, str(tmp_path / "q.db")) as gw:
            t1 = gw.enqueue(_spec(_double, 20), tenant="alice")
            t2 = gw.enqueue(_spec(_double, 10), tenant="bob")
            h1, h2 = gw.attach(t1), gw.attach(t2)
            assert h1.result(timeout=60) == _jax_result(_double, 20)
            assert h2.result(timeout=60) == _jax_result(_double, 10)
            assert h1.status() == "done" and h1.done()
            stats = h1.stats()
            assert stats["tenant"] == "alice"
            assert stats["items_collected"] == 20
            with pytest.raises(KeyError):
                gw.attach("tnope")
        counts = svc.telemetry.snapshot()["cluster"]
        assert counts["tickets_enqueued"] == 2
        assert counts["tickets_done"] == 2


def test_bad_ticket_fails_alone_and_pump_survives(tmp_path):
    """One malformed spec fails only its own ticket: the pump thread
    survives admission errors (it used to re-raise and die, stranding
    every tenant's tickets as queued forever), so a good ticket enqueued
    after the bad one is still admitted and completes."""
    with _service() as svc:
        with JobGateway(svc, str(tmp_path / "q.db")) as gw:
            bad = gw.enqueue(object(), tenant="mallory")  # not a spec
            good = gw.enqueue(_spec(_double, 10), tenant="alice")
            hb, hg = gw.attach(bad), gw.attach(good)
            assert hg.result(timeout=60) == _jax_result(_double, 10)
            assert hb.wait(timeout=30)
            assert hb.status() == "failed"
            with pytest.raises(RuntimeError, match="AttributeError"):
                hb.result(timeout=5)
        counts = svc.telemetry.snapshot()["cluster"]
        assert counts["tickets_failed"] == 1
        assert counts["tickets_done"] == 1


def test_ticket_survives_gateway_crash_and_restart(tmp_path):
    """The durability pillar: enqueue, crash the gateway before admission,
    restart over the same database, attach, get the result — and the
    warm pool means the recovered job reports cluster_boot_ms == 0."""
    db = str(tmp_path / "q.db")
    with _service() as svc:
        # Warm the pool so boot is charged before the gateway exists.
        svc.submit(_spec(_double, 4), timeout=60).result()
        # A zero-slot tenant policy keeps the ticket queued: the crash
        # happens before the job ever reaches the pool.
        gw1 = JobGateway(svc, db,
                         default_policy=TenantPolicy(max_active_jobs=0))
        ticket = gw1.enqueue(_spec(_double, 30), tenant="alice")
        time.sleep(0.2)
        assert gw1.attach(ticket).status() == "queued"
        gw1.kill()  # the simulated crash: no reaping, no state rewrite
        gw2 = JobGateway(svc, db)
        try:
            handle = gw2.attach(ticket)
            assert handle.result(timeout=60) == _jax_result(_double, 30)
            stats = handle.stats()
            assert stats["state"] == "done"
            assert stats["cluster_boot_ms"] == 0.0
        finally:
            gw2.close()


def test_running_ticket_requeued_after_crash(tmp_path):
    """A ticket caught mid-run by the crash is recovered: the next gateway
    requeues it from the row alone (lazy spec unpickle) and it completes."""
    db = str(tmp_path / "q.db")
    with _service() as svc:
        gw1 = JobGateway(svc, db)
        ticket = gw1.enqueue(_spec(_slow_double, 40), tenant="alice")
        handle = gw1.attach(ticket)
        deadline = time.monotonic() + 30
        while handle.status() != "running":
            assert time.monotonic() < deadline, "never admitted"
            time.sleep(0.02)
        gw1.kill()
        peek = TicketStore(db)
        assert peek.get(ticket).state == "running"
        peek.close()
        gw2 = JobGateway(svc, db)
        try:
            assert gw2.attach(ticket).result(timeout=120) == \
                _jax_result(_double, 40)
        finally:
            gw2.close()


def test_queued_timeout_reports_cancelled(tmp_path):
    """submit(timeout=) on a job still queued at its deadline: it leaves
    the queue and reports cancelled — it can never hold a slot forever."""
    with _service() as svc:
        gw = JobGateway(svc, str(tmp_path / "q.db"),
                        default_policy=TenantPolicy(max_active_jobs=0))
        try:
            ticket = gw.enqueue(_spec(_double, 5), timeout=0.3)
            handle = gw.attach(ticket)
            assert handle.wait(timeout=30)
            assert handle.status() == "cancelled"
            with pytest.raises(JobCancelled, match="timed out"):
                handle.result(timeout=5)
            assert gw.queued_count() == 0
        finally:
            gw.close()


def test_cancel_queued_ticket(tmp_path):
    with _service() as svc:
        gw = JobGateway(svc, str(tmp_path / "q.db"),
                        default_policy=TenantPolicy(max_active_jobs=0))
        try:
            ticket = gw.enqueue(_spec(_double, 5))
            assert gw.cancel(ticket) is True
            assert gw.attach(ticket).status() == "cancelled"
            with pytest.raises(JobCancelled):
                gw.attach(ticket).result(timeout=5)
            assert gw.cancel(ticket) is False  # already gone
        finally:
            gw.close()


def test_fair_admission_interleaves_tenants(tmp_path):
    """With one admission slot, fair mode alternates tenants even though
    the wide tenant enqueued first at a higher priority; fifo mode admits
    strictly by priority — the narrow tenant waits behind every wide job."""

    def admitted_tenants(mode):
        with _service() as svc:
            gw = JobGateway(svc, str(tmp_path / f"{mode}.db"),
                            mode=mode, max_active_jobs=1)
            try:
                handles = []
                for i in range(2):
                    handles.append(gw.attach(gw.enqueue(
                        _spec(_slow_double, 8), tenant="wide", priority=5)))
                for i in range(2):
                    handles.append(gw.attach(gw.enqueue(
                        _spec(_double, 2), tenant="narrow", priority=0)))
                for h in handles:
                    assert h.result(timeout=120) is not None
                events = svc.telemetry.events_since(0, limit=1000)
                return [e["tenant"] for e in events
                        if e["kind"] == "ticket_admitted"]
            finally:
                gw.close()

    fair = admitted_tenants("fair")
    assert fair[0] == "wide"  # enqueued first into an empty gateway
    assert "narrow" in fair[1:3], f"narrow starved under fair: {fair}"
    fifo = admitted_tenants("fifo")
    assert fifo[:2] == ["wide", "wide"], f"fifo baseline changed: {fifo}"


def test_tenant_max_inflight_caps_dispatch(tmp_path):
    """The per-tenant credit cap rides into host_loader._answer: with
    max_inflight=2 no WORK_BATCH may carry more than 2 items, even though
    the pool's credit window would otherwise batch more."""
    with _service(workers=4) as svc:
        gw = JobGateway(svc, str(tmp_path / "q.db"),
                        tenants={"capped": TenantPolicy(max_inflight=2)})
        try:
            handle = gw.attach(gw.enqueue(_spec(_double, 30, workers=4),
                                          tenant="capped"))
            assert handle.result(timeout=60) == _jax_result(_double, 30)
            assert svc.host_loader.stats.max_batch <= 2
        finally:
            gw.close()


def test_autoscaler_grows_on_backlog_and_shrinks_idle(tmp_path):
    """Queued demand grows the pool through the late-join path; a fully
    idle gateway retires the extra node through graceful retirement."""
    policy = AutoscalePolicy(min_nodes=1, max_nodes=2, scale_up_wait_s=0.1,
                             backlog_per_node=2.0, idle_shrink_s=0.5,
                             cooldown_s=0.3, interval_s=0.05)
    with _service(nodes=1) as svc:
        # max_active_jobs=2 keeps the third ticket visibly *queued* while
        # the first two run — the backlog the scale-up conditions read.
        gw = JobGateway(svc, str(tmp_path / "q.db"), autoscale=policy,
                        max_active_jobs=2)
        try:
            handles = [gw.attach(gw.enqueue(_spec(_slow_double, 20)))
                       for _ in range(3)]
            for h in handles:
                assert h.result(timeout=120) == _jax_result(_double, 20)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                counters = svc.telemetry.snapshot()["cluster"]
                if (counters.get("scale_up_events", 0) >= 1
                        and counters.get("scale_down_events", 0) >= 1
                        and len(svc.pool_alive()) == 1):
                    break
                time.sleep(0.1)
            counters = svc.telemetry.snapshot()["cluster"]
            assert counters.get("scale_up_events", 0) >= 1
            assert counters.get("scale_down_events", 0) >= 1
            assert len(svc.pool_alive()) == 1  # back at min_nodes
            # The pool still works after the full grow/shrink cycle.
            assert gw.attach(gw.enqueue(_spec(_double, 6))).result(
                timeout=60) == _jax_result(_double, 6)
        finally:
            gw.close()


def test_gateway_telemetry_sampler_and_prometheus(tmp_path):
    with _service() as svc:
        gw = JobGateway(svc, str(tmp_path / "q.db"),
                        tenants={"alice": TenantPolicy(weight=2.0,
                                                       max_inflight=4)})
        try:
            gw.attach(gw.enqueue(_spec(_double, 8),
                                 tenant="alice")).result(timeout=60)
            snap = svc.telemetry.snapshot()
            assert snap["gateway"]["mode"] == "fair"
            assert snap["gateway"]["tickets"] == {"done": 1}
            prom = svc.telemetry.prometheus()
            assert 'repro_gateway_tickets{state="done"} 1' in prom
        finally:
            gw.close()


def test_gateway_rejects_bad_arguments(tmp_path):
    with _service() as svc:
        with pytest.raises(ValueError):
            JobGateway(svc, str(tmp_path / "a.db"), max_active_jobs=0)
        gw = JobGateway(svc, str(tmp_path / "q.db"))
        try:
            with pytest.raises(ValueError):
                gw.enqueue(_spec(_double, 2), retries=-1)
        finally:
            gw.close()
        with pytest.raises(RuntimeError):
            gw.enqueue(_spec(_double, 2))  # closed gateway
