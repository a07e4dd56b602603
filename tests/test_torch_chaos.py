"""The port's fault injection and self-healing (``repro_torch.cluster.chaos``).

Mirrors the 14 tests of ``tests/test_chaos.py``.  The fault harness attacks
the *real* transport — node kills through the deployment layer,
drop/delay/duplicate/corrupt at the frame layer — and these tests assert
the healing machinery it exists to exercise: mid-run pool healing (dead ->
launching -> registered, warm code re-shipped), per-job retry with attempt
history and the poisoned-job guard, zombie dedup under stalled heartbeats,
the decode-error death path, and the JOB_CLOSE / backoff-jitter fixes that
ride along.  Every job's result is held against the same job on the JAX
package's threads backend, and the fault plan's validation errors against
the JAX package's.  Everything runs on 127.0.0.1 with an InProcessLauncher.
"""

import os
import random
import socket
import time

import pytest

from repro.cluster.chaos import Fault as JaxFault
from repro.cluster.chaos import FaultPlan as JaxFaultPlan
from repro.core import builder as jax_builder
from repro.core import dsl as jax_dsl
from repro.core import processes as jax_proc
from repro_torch.cluster.chaos import (
    ChaosController,
    Fault,
    FaultPlan,
    FaultyConnection,
    WireFaults,
)
from repro_torch.cluster.deploy.inprocess import InProcessLauncher
from repro_torch.cluster.host_loader import HostLoader
from repro_torch.cluster.node_loader import connect_with_retry
from repro_torch.cluster.service import ClusterService
from repro_torch.cluster.wire import Frame, FrameType
from repro_torch.core.dsl import ClusterSpec
from repro_torch.core.processes import EmitDetails, ResultDetails
from repro_torch.runtime.failures import WorkFunctionError

# Fast liveness (death detected within ~0.4s), for the cases whose faults
# kill, stall or cut a node; anything tighter makes healthy-but-GIL-contended
# in-process nodes flap dead.
FAST = dict(heartbeat_interval=0.1, heartbeat_misses=4)
# The retry cases assert the kind of each attempt's failure, not a death:
# 10 s of silence, so a loaded machine cannot turn one into a node loss.
SLACK = dict(heartbeat_interval=0.5, heartbeat_misses=20)


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


def _service(**kw):
    kw.setdefault("nodes", 2)
    kw.setdefault("workers", 2)
    kw.setdefault("launcher", InProcessLauncher())
    for key, val in FAST.items():
        kw.setdefault(key, val)
    return ClusterService(**kw)


def _event_kinds(svc):
    return [e["kind"] for e in svc.telemetry.events_since(0, limit=500)]


def _double(x):
    return x * 2


def _triple(x):
    return x * 3


def _slow_double(x):
    time.sleep(0.02)
    return x * 2


def _always_raises(x):
    raise RuntimeError(f"poisoned item {x}")


# ---------------------------------------------------------------------------
# plan validation
# ---------------------------------------------------------------------------


def test_fault_plan_validation():
    bad = [
        ("unknown fault kind", ("meteor",), {}),
        ("must name their node", ("kill_node",), {}),
        ("probability", ("drop",), {"probability": 0.0}),
        ("unknown frame type", ("drop",), {"frame_types": ("BOGUS",)}),
        ("count", ("corrupt",), {"count": 0}),
    ]
    for match, args, kw in bad:
        with pytest.raises(ValueError, match=match) as port_err:
            FaultPlan([Fault(*args, **kw)]).validate()
        with pytest.raises(ValueError) as jax_err:
            JaxFaultPlan([JaxFault(*args, **kw)]).validate()
        assert str(port_err.value) == str(jax_err.value)
    # A sane plan validates (and the controller validates on construction).
    FaultPlan([
        Fault("kill_node", node="node1", after_items=3),
        Fault("straggler", node="node0", at_s=0.1, delay_s=0.01),
    ]).validate()


# ---------------------------------------------------------------------------
# the acceptance scenario: kill one node mid-job on a 4-node pool, heal
# ---------------------------------------------------------------------------


def test_kill_mid_job_heals_pool_and_completes():
    """A FaultPlan kills node1 mid-job on a 4-node pool with a heal
    budget: the job completes with exact results, the pool heals (a
    replacement launch registers), and the kill + failure + heal are all
    on the telemetry bus and in the metrics snapshot."""
    plan = FaultPlan([Fault("kill_node", node="node1", after_items=10)])
    with _service(nodes=4, max_heals=1, chaos=plan) as svc:
        handle = svc.submit(_spec(_slow_double, 400, nclusters=4), timeout=120)
        assert handle.result(timeout=120) == _jax_result(_double, 400)

        stats = handle.stats()
        assert stats["respawns"] >= 1
        assert stats["heals"] >= 1

        hl = svc.host_loader
        assert hl.stats.deaths_detected >= 1
        # The replacement is a real membership member, not just a counter:
        # node1's heal announced node1r2, which must have launched and
        # (given the in-process launcher's instant boot) registered.
        replacements = [nid for nid in hl.membership.nodes if nid.startswith("node1r")]
        assert replacements, hl.membership.nodes.keys()
        new_rec = hl.membership.nodes[replacements[0]]
        states = [s for s, _ in new_rec.transitions]
        assert states[0] == "launching"
        assert "registered" in states
        # The dead original records its failure with detection metadata.
        dead = hl.membership.nodes["node1"]
        assert dead.state == "dead"
        assert dead.last_failure is not None
        assert dead.last_failure.node_id == "node1"
        assert dead.last_failure.detect_latency_s > 0.0

        kinds = _event_kinds(svc)
        assert "chaos_inject" in kinds
        assert "failure" in kinds
        assert "heal" in kinds

        snap = svc.metrics_snapshot()
        assert snap["chaos"]["faults_injected"] == 1
        assert snap["chaos"]["fired"][0]["kind"] == "kill_node"
        assert snap["cluster"]["heals"] >= 1
        assert snap["cluster"]["failures_detected"] >= 1
        # Attempt history is published even for the single-attempt job.
        assert stats["attempts"][0]["job_id"] == handle.job_id
        assert stats["attempts"][0]["error"] is None
    assert svc.orphaned() == []


def test_heal_relaunch_failure_shrinks_to_survivors():
    """When the launcher cannot place a replacement the heal is reported
    (heal_failed) and the historical shrink-to-survivors behaviour carries
    the job; close() still orphans nothing."""

    class NoReplacements(InProcessLauncher):
        def launch(self, node_id, *, avoid=()):
            if "r" in node_id.removeprefix("node"):
                raise RuntimeError("no capacity for replacements")
            return super().launch(node_id, avoid=avoid)

    plan = FaultPlan([Fault("kill_node", node="node1", after_items=5)])
    with _service(nodes=2, launcher=NoReplacements(), max_heals=2,
                  chaos=plan) as svc:
        handle = svc.submit(_spec(_slow_double, 80), timeout=120)
        assert handle.result(timeout=120) == _jax_result(_double, 80)
        assert svc.host_loader.stats.heals == 0
        assert svc.host_loader.stats.deaths_detected >= 1
        kinds = _event_kinds(svc)
        assert "heal_failed" in kinds
        assert "heal" not in kinds
    assert svc.orphaned() == []


def test_heal_budget_defaults_to_zero():
    """Without max_heals a mid-run death shrinks the pool — no launches,
    no LAUNCHING records, exactly the pre-heal behaviour."""
    plan = FaultPlan([Fault("kill_node", node="node1", after_items=5)])
    with _service(nodes=2, chaos=plan) as svc:
        handle = svc.submit(_spec(_slow_double, 60), timeout=120)
        assert handle.result(timeout=120) == _jax_result(_double, 60)
        hl = svc.host_loader
        assert hl.stats.heals == 0
        assert hl.stats.respawns == 0
        assert not [n for n in hl.membership.nodes if "r" in n.removeprefix("node")]
    assert svc.orphaned() == []


# ---------------------------------------------------------------------------
# per-job retry policy
# ---------------------------------------------------------------------------


def test_poisoned_job_stops_after_retries_with_history():
    """A deterministically failing work function is retried exactly
    ``retries`` times, then the handle resolves with the error and the
    full attempt history (cause, node, timing) on the handle."""
    with _service(**SLACK) as svc:
        handle = svc.submit(_spec(_always_raises, 8), timeout=30,
                            retries=2, backoff=0.01)
        with pytest.raises(WorkFunctionError, match="poisoned item"):
            handle.result(timeout=60)
        assert handle.done()
        assert len(handle.attempts) == 3  # 1 original + 2 retries
        for i, rec in enumerate(handle.attempts):
            assert rec["attempt"] == i + 1
            assert rec["cause"] == "work_function"
            assert rec["error_type"] == "WorkFunctionError"
            assert rec["node"] in svc.host_loader.membership.nodes
            assert rec["elapsed_ms"] is not None
        # Each attempt was a distinct job id on the pool.
        assert len({rec["job_id"] for rec in handle.attempts}) == 3
        stats = handle.stats()
        assert stats["retries"] == 2
        assert [a["attempt"] for a in stats["attempts"]] == [1, 2, 3]
        kinds = _event_kinds(svc)
        assert kinds.count("job_retry") == 2
        # The history is also in the metrics snapshot's job gauges.
        snap = svc.metrics_snapshot()
        last_job = str(handle.job_id)
        assert len(snap["jobs"][last_job]["attempts"]) == 3
    assert svc.orphaned() == []


def test_retry_recovers_from_transient_failure(tmp_path):
    """A failure that clears (the transient kind retries exist for) is
    healed by the second attempt; the result is exact and the history
    shows one failed and one clean attempt."""
    trip = tmp_path / "trip"
    trip.write_text("armed")

    def flaky(x):
        if os.path.exists(str(trip)):
            raise RuntimeError("transient outage")
        return x * 2

    with _service(**SLACK) as svc:
        handle = svc.submit(_spec(flaky, 12), timeout=30,
                            retries=3, backoff=0.3)
        # Clear the failure condition once the first attempt has failed.
        deadline = time.monotonic() + 20
        while not handle.attempts and time.monotonic() < deadline:
            time.sleep(0.01)
        assert handle.attempts, "first attempt never finished"
        trip.unlink()
        assert handle.result(timeout=60) == _jax_result(_double, 12)
        assert len(handle.attempts) >= 2
        assert handle.attempts[0]["error_type"] == "WorkFunctionError"
        assert handle.attempts[0]["backoff_ms"] > 0
        assert handle.attempts[-1]["error"] is None
    assert svc.orphaned() == []


def test_submit_rejects_bad_retry_policy():
    svc = _service()
    try:
        with pytest.raises(ValueError, match="retries"):
            svc.submit(_spec(_double, 4), retries=-1)
        with pytest.raises(ValueError, match="backoff"):
            svc.submit(_spec(_double, 4), retries=1, backoff=-0.5)
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# wire faults: zombies, duplicates, corruption
# ---------------------------------------------------------------------------


def test_stalled_heartbeats_make_a_zombie_dedup_reconciles():
    """stall_heartbeat drops only the beats: the host declares a healthy
    node dead and redispatches, while the zombie keeps delivering — the
    result-id dedup keeps collection exactly-once and the job exact."""
    plan = FaultPlan([Fault("stall_heartbeat", node="node1", at_s=0.2)])
    with _service(chaos=plan) as svc:
        handle = svc.submit(_spec(_slow_double, 150), timeout=120)
        assert handle.result(timeout=120) == _jax_result(_double, 150)
        hl = svc.host_loader
        assert hl.stats.deaths_detected >= 1  # a false positive, by design
        assert hl.membership.nodes["node1"].state in ("dead", "done")
        # Host-level and job-level dedup accounting reconcile.
        assert hl.stats.duplicates_dropped == handle.stats()["duplicates_dropped"]
    assert svc.orphaned() == []


def test_corrupt_frame_exercises_decode_death_path():
    """A corrupted WORK_BATCH (codec byte rewritten on the wire) makes the
    node's decode raise, which it treats as a dead host and exits; the
    host reaps it and survivors finish the job exactly."""
    plan = FaultPlan([Fault("corrupt", node="node1", at_s=0.1, count=1)])
    with _service(chaos=plan) as svc:
        handle = svc.submit(_spec(_slow_double, 80), timeout=120)
        assert handle.result(timeout=120) == _jax_result(_double, 80)
        rec = svc.host_loader.membership.nodes["node1"]
        assert rec.state in ("dead", "done")  # clean retire or reaped
        snap = svc.metrics_snapshot()
        assert snap["chaos"]["faults_injected"] == 1
    assert svc.orphaned() == []


def test_soak_interleaved_faults_two_concurrent_jobs():
    """The satellite soak: kill + delay + duplicate interleaved while two
    jobs share a 3-node pool.  Both results stay exact and the dedup
    counters reconcile between the host and the per-job stats."""
    plan = FaultPlan([
        Fault("duplicate", node="node0", at_s=0.0),
        Fault("delay", node="node2", at_s=0.1, duration_s=1.0, delay_s=0.01),
        Fault("kill_node", node="node1", after_items=15),
    ])
    with _service(nodes=3, max_heals=1, chaos=plan) as svc:
        h1 = svc.submit(_spec(_slow_double, 200, nclusters=3), timeout=120)
        h2 = svc.submit(_spec(_triple, 90, nclusters=3), timeout=120,
                        priority=1)
        assert h1.result(timeout=120) == _jax_result(_double, 200)
        assert h2.result(timeout=120) == _jax_result(_triple, 90)
        hl = svc.host_loader
        s1, s2 = h1.stats(), h2.stats()
        # Exactly-once per job: every item collected once, and the host's
        # duplicate count is exactly the sum of the per-job drops.
        assert s1["items_collected"] == 200
        assert s2["items_collected"] == 90
        assert (hl.stats.duplicates_dropped
                == s1["duplicates_dropped"] + s2["duplicates_dropped"])
        # The duplicate fault ran against node0's results, so dedup really
        # was exercised (not a vacuous reconciliation).
        assert hl.stats.duplicates_dropped >= 1
        # Per-job node attribution still sums to the collected items.
        assert sum(d.get("items", 0) for d in s1["nodes"].values()) == 200
        assert sum(d.get("items", 0) for d in s2["nodes"].values()) == 90
        assert hl.stats.deaths_detected >= 1
        snap = svc.metrics_snapshot()
        assert snap["chaos"]["faults_injected"] == 3
    assert svc.orphaned() == []


# ---------------------------------------------------------------------------
# FaultyConnection unit behaviour (no cluster needed)
# ---------------------------------------------------------------------------


class _ScriptedConn:
    """A FrameConnection stand-in: recv pops a script, send records."""

    def __init__(self, frames):
        self.frames = list(frames)
        self.sent = []
        self.raw = []
        self.peer = "scripted"

    def recv(self):
        if not self.frames:
            raise ConnectionError("script exhausted")
        return self.frames.pop(0)

    def send(self, frame):
        self.sent.append(frame)

    def send_raw(self, bufs):
        self.raw.append(bufs)

    def close(self):
        pass


def _beat(node="nodeX"):
    return Frame(FrameType.HEARTBEAT, {"node_id": node}, 2)


def _register(node="nodeX"):
    return Frame(FrameType.REGISTER, {"node_id": node}, 1)


def test_faulty_connection_drop_delay_duplicate_and_corrupt():
    faults = WireFaults(random.Random(0))
    conn = _ScriptedConn([_register(), _beat(), _beat(),
                          Frame(FrameType.RESULT_BATCH, {"results": []}, 2)])
    fc = FaultyConnection(conn, faults)

    # Identity is learned from REGISTER passing through.
    assert fc.recv().ftype is FrameType.REGISTER
    assert fc.node_id == "nodeX"

    # Install: drop heartbeats, duplicate result batches.
    plan = FaultPlan([
        Fault("stall_heartbeat", node="nodeX"),
        Fault("duplicate", node="nodeX"),
    ])
    ctl = ChaosController(plan)
    ctl.wire = faults  # route the rules into this test's registry
    ctl._armed_at = 0.0
    for f in plan.faults:
        ctl._fire(f, 0.0, 0)

    # Both beats are swallowed; the RESULT_BATCH arrives twice.
    first = fc.recv()
    assert first.ftype is FrameType.RESULT_BATCH
    dup = fc.recv()
    assert dup.ftype is FrameType.RESULT_BATCH
    assert ctl.injected == 2

    # Corrupt on send: the frame goes out raw with the codec byte mangled.
    ctl._fire(Fault("corrupt", node="nodeX", count=1), 0.0, 0)
    fc.send(Frame(FrameType.WORK_BATCH, {"items": []}, 2, job_id=1))
    assert len(conn.raw) == 1
    header = bytes(conn.raw[0][0])
    assert header[6] == 0x7F  # invalid codec id
    # The count is spent: the next send goes through clean.
    fc.send(Frame(FrameType.WORK_BATCH, {"items": []}, 2, job_id=1))
    assert len(conn.sent) == 1


def test_wire_rules_expire_and_respect_probability():
    faults = WireFaults(random.Random(1))
    fault = Fault("drop", node=None, duration_s=0.05,
                  frame_types=("HEARTBEAT",))
    plan = FaultPlan([fault])
    ctl = ChaosController(plan)
    ctl.wire = faults
    ctl._fire(fault, 0.0, 0)
    assert faults.match("any", "recv", _beat()) is not None
    time.sleep(0.08)
    assert faults.match("any", "recv", _beat()) is None
    assert faults.active_count() == 0


# ---------------------------------------------------------------------------
# satellite: JOB_CLOSE on every error path
# ---------------------------------------------------------------------------


class _RecordingConn:
    def __init__(self):
        self.sent = []
        self.peer = "fake"

    def send(self, frame):
        self.sent.append(frame)

    def close(self):
        pass


def test_failed_jobs_always_send_job_close():
    """Timed-out/aborted jobs tear down on the wire: JOB_CLOSE reaches
    every live node — pinned jobs and nodes whose LOAD never acked
    included — so nobody keeps computing for a corpse."""
    hl = HostLoader(None, pool_nodes=2, pool_workers=1)
    try:
        conn_a = _RecordingConn()
        conn_b = _RecordingConn()
        hl.membership.register("node0", "a:1", conn=conn_a)
        hl.membership.register("node1", "b:1", conn=conn_b)
        job = hl._new_job(_spec(_double, 4), pinned=True)
        hl._jobs[job.job_id] = job
        # node0 acked the LOAD, node1's is still in flight.
        hl.membership.nodes["node0"].jobs_loaded.add(job.job_id)

        hl._fail_job(job, TimeoutError("deadline"))
        assert job.failure_kind == "timeout"
        for conn in (conn_a, conn_b):
            closes = [f for f in conn.sent
                      if f.ftype is FrameType.JOB_CLOSE
                      and f.job_id == job.job_id]
            assert len(closes) == 1
        assert job.job_id not in hl.membership.nodes["node0"].jobs_loaded

        # A LOAD ack landing after the job ended closes instead of binding.
        hl._apply_load_result("node1", True, job.job_id)
        assert job.job_id not in hl.membership.nodes["node1"].jobs_loaded
        late_closes = [f for f in conn_b.sent
                       if f.ftype is FrameType.JOB_CLOSE]
        assert len(late_closes) == 2
    finally:
        hl.close()


# ---------------------------------------------------------------------------
# satellite: connect retry backoff jitter + cap
# ---------------------------------------------------------------------------


def test_connect_retry_backoff_jitter_and_cap(monkeypatch):
    """The reconnect schedule doubles to a cap, and jitter decorrelates it
    (a healed pool's mass redial must not reconnect in lockstep)."""
    attempts = {"n": 0}
    server, client = socket.socketpair()

    def flaky_create(addr, timeout=None):
        attempts["n"] += 1
        if attempts["n"] <= 5:
            raise OSError("connection refused")
        return client

    monkeypatch.setattr(socket, "create_connection", flaky_create)
    try:
        sleeps = []
        sock = connect_with_retry("127.0.0.1", 1, timeout=60.0,
                                  max_delay=1.0, jitter=0.0,
                                  _sleep=sleeps.append)
        assert sock is client
        assert sleeps == [0.2, 0.4, 0.8, 1.0, 1.0]  # doubling, capped

        attempts["n"] = 0
        jittered = []
        connect_with_retry("127.0.0.1", 1, timeout=60.0, max_delay=1.0,
                           jitter=0.5, _sleep=jittered.append,
                           _rng=random.Random(42))
        base = [0.2, 0.4, 0.8, 1.0, 1.0]
        assert all(0.5 * b <= s <= b for s, b in zip(jittered, base))
        assert jittered != base  # the draw actually moved the schedule
    finally:
        server.close()
        client.close()
