"""The port's deployment layer (``repro_torch.cluster.deploy``) and the
host's placement policy, on localhost sockets and the CPU.

Mirrors the tests of ``tests/test_deploy.py`` that do not need ssh:
membership states, policy validation, the node-loader's connect retry, and
the policy end to end — degraded start (``min_nodes``), respawn of a silent
launch (``max_respawns``, ``respawn_after``), late join mid-run (an
announced straggler, and a stranger under both settings of
``allow_late_join``), no
spurious respawn behind a slow ``prepare``, the strict barrier, teardown
after a fan-out that fails midway, and ``LocalLauncher`` as the default.
The policy runs its node-loaders as threads (``InProcessLauncher``) over
the same TCP protocol.  The ssh launcher is not ported yet
(``test_torch_builder.py`` checks that ``hosts=`` says so).
"""

import socket
import threading
import time

import pytest

from repro_torch.cluster.deploy import (
    InProcessLauncher,
    LocalLauncher,
    PlacementPolicy,
)
from repro_torch.cluster.deploy.base import NodeHandle
from repro_torch.cluster.membership import (
    DONE,
    LAUNCHING,
    REGISTERED,
    REPLACED,
    Membership,
)
from repro_torch.cluster.node_loader import connect_with_retry, run_node
from repro_torch.core.builder import ClusterBuilder
from repro_torch.core.dsl import ClusterSpec
from repro_torch.core.processes import EmitDetails, ResultDetails
from repro_torch.runtime.failures import HeartbeatMonitor

# Fast liveness settings for tests (death detected within ~0.4s).
FAST = dict(heartbeat_interval=0.1, heartbeat_misses=4)


def _range_emit(n):
    return EmitDetails(
        name="range",
        init=lambda limit: (0, limit),
        init_data=(n,),
        create=lambda s: (None, s) if s[0] >= s[1] else (s[0], (s[0] + 1, s[1])),
    )


def _spec(nclusters, workers, n_items, work):
    return ClusterSpec.simple(
        host="127.0.0.1", nclusters=nclusters, workers_per_node=workers,
        emit_details=_range_emit(n_items), work_function=work,
        result_details=ResultDetails(name="sum", init=lambda: 0,
                                     collect=lambda a, x: a + x),
    )


class DeadHandle(NodeHandle):
    """A launch some machine swallowed: accepted, never came up."""

    def __init__(self, node_id):
        self.node_id = node_id
        self.where = "void"

    def poll(self):
        return 1

    def wait(self, timeout=None):
        return 1

    def kill(self):
        pass

    def logs(self):
        return []


class FlakyLauncher(InProcessLauncher):
    """Silently drops the first launch of the named nodes (they never dial
    the host) — the idle-workstation pool's classic failure mode."""

    def __init__(self, drop_first=(), **kw):
        super().__init__(**kw)
        self._drop = set(drop_first)
        self.dropped = []

    def launch(self, node_id, *, avoid=()):
        if node_id in self._drop:
            self._drop.discard(node_id)
            self.dropped.append(node_id)
            self.launched.append(node_id)
            return DeadHandle(node_id)
        return super().launch(node_id, avoid=avoid)


# ---------------------------------------------------------------------------
# membership states and policy validation
# ---------------------------------------------------------------------------


def test_membership_launch_register_replace_lifecycle():
    m = Membership(HeartbeatMonitor())
    rec = m.expect("node0", now=0.0)
    assert rec.state == LAUNCHING and not rec.alive
    # An announced launch neither counts as arrived nor blocks termination.
    assert m.arrived_count() == 0
    assert m.finished()
    with pytest.raises(ValueError):
        m.expect("node0")

    # Respawn: retire the silent launch, announce its replacement.
    m.replace("node0")
    assert m.nodes["node0"].state == REPLACED
    m.expect("node0r2", now=1.0).attempts = 2
    m.register("node0r2", "127.0.0.1:5", now=1.5)
    assert m.nodes["node0r2"].state == REGISTERED
    assert m.arrived_count() == 1

    # The replaced original showing up late is still a usable worker.
    m.register("node0", "127.0.0.1:6", now=2.0)
    assert m.nodes["node0"].state == REGISTERED
    assert m.arrived_count() == 2
    # ...but a duplicate of a live member is rejected.
    with pytest.raises(ValueError):
        m.register("node0r2", "127.0.0.1:7")
    with pytest.raises(ValueError):
        m.replace("node0")

    m.mark_done("node0")
    m.mark_done("node0r2")
    assert m.finished()


def test_placement_policy_validation():
    PlacementPolicy().validate(3)
    PlacementPolicy(min_nodes=1, max_respawns=2).validate(3)
    with pytest.raises(ValueError, match="min_nodes"):
        PlacementPolicy(min_nodes=0).validate(3)
    with pytest.raises(ValueError, match="min_nodes"):
        PlacementPolicy(min_nodes=4).validate(3)
    with pytest.raises(ValueError, match="max_respawns"):
        PlacementPolicy(max_respawns=-1).validate(3)


# ---------------------------------------------------------------------------
# node-loader connect retry
# ---------------------------------------------------------------------------


def _free_port():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # free the port: nobody is listening now
    return port


def test_connect_retry_waits_for_late_listener():
    """A node-loader may start before the host is listening (uncontrolled
    remote start order): the dial must retry, not die on ECONNREFUSED."""
    port = _free_port()
    got = {}

    def dial():
        try:
            sock = connect_with_retry("127.0.0.1", port, timeout=10.0)
            got["peer"] = sock.getpeername()
            sock.close()
        except OSError as exc:  # pragma: no cover - failure diagnostics
            got["error"] = exc

    t = threading.Thread(target=dial, daemon=True)
    t.start()
    time.sleep(0.6)  # let several refused attempts happen
    listener = socket.socket()
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("127.0.0.1", port))
    listener.listen(1)
    t.join(timeout=10)
    listener.close()
    assert not t.is_alive()
    assert got.get("peer") == ("127.0.0.1", port), got


def test_connect_retry_gives_up_after_timeout():
    port = _free_port()
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="could not reach"):
        connect_with_retry("127.0.0.1", port, timeout=0.5)
    assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# placement policy, end to end over the InProcessLauncher
# ---------------------------------------------------------------------------


def test_degraded_start_admits_job_with_min_nodes():
    """One launch is swallowed; min_nodes=1 admits the job with the
    survivor instead of raising at the registration barrier."""
    launcher = FlakyLauncher(drop_first=["node1"], connect_timeout=5.0)
    app = ClusterBuilder().build_application(
        _spec(2, 2, 30, lambda x: x * x), backend="cluster",
        launcher=launcher, min_nodes=1, register_timeout=0.6,
        job_timeout=60.0, **FAST,
    )
    assert app.run() == sum(i * i for i in range(30))
    hl = app.host_loader
    assert hl.stats.degraded_start
    assert hl.stats.items_total == 30
    assert hl.membership.nodes["node0"].state == DONE
    # The straggler stays LAUNCHING — still eligible to late-join a longer
    # job — and never blocked termination.
    assert hl.membership.nodes["node1"].state == LAUNCHING
    assert app.orphaned() == []


def test_silent_node_is_respawned_and_job_runs_at_full_strength():
    """A node that never registers is relaunched (up to max_respawns): the
    job starts at full strength with the replacement doing real work."""
    launcher = FlakyLauncher(drop_first=["node1"], connect_timeout=5.0)
    app = ClusterBuilder().build_application(
        _spec(2, 1, 40, lambda x: 3 * x), backend="cluster",
        launcher=launcher, max_respawns=1, respawn_after=0.3,
        register_timeout=10.0, job_timeout=60.0, **FAST,
    )
    assert app.run() == sum(3 * i for i in range(40))
    hl = app.host_loader
    assert hl.stats.respawns == 1
    assert not hl.stats.degraded_start
    assert hl.membership.nodes["node1"].state == REPLACED
    assert hl.membership.nodes["node1r2"].state == DONE
    assert hl.membership.nodes["node1r2"].attempts == 2
    # The replacement was a genuine worker, not a bystander.
    assert hl.membership.nodes["node1r2"].items_done > 0
    assert launcher.launched == ["node0", "node1", "node1r2"]
    assert app.orphaned() == []


def test_late_join_mid_run_gets_load_and_credits_exactly_once():
    """A node registering after the run started is admitted, shipped LOAD,
    and answered credits immediately; results stay exactly-once."""
    n_items = 40
    launcher = InProcessLauncher(connect_timeout=10.0,
                                 delays={"node1": 0.9})

    def work(x):
        time.sleep(0.05)
        return x + 1

    app = ClusterBuilder().build_application(
        _spec(2, 1, n_items, work), backend="cluster",
        launcher=launcher, min_nodes=1, register_timeout=0.3,
        job_timeout=60.0, **FAST,
    )
    assert app.run() == sum(i + 1 for i in range(n_items))
    hl = app.host_loader
    assert hl.stats.degraded_start  # node1 missed the barrier...
    assert hl.stats.late_joins == 1  # ...then joined mid-run
    assert hl.stats.items_total == n_items
    assert hl.stats.duplicates_dropped == 0
    assert hl.membership.nodes["node1"].state == DONE
    assert hl.membership.nodes["node1"].items_done > 0
    assert app.orphaned() == []


@pytest.mark.parametrize("allow", [True, False], ids=["allowed", "refused"])
def test_stranger_late_join_follows_the_policy(allow):
    """A node-loader nobody launched dials in mid-run: admitted and fed
    work under the default policy, turned away (connection closed) under
    allow_late_join=False.  Either way the result is exactly-once."""
    n_items = 40

    def work(x):
        time.sleep(0.05)
        return x + 1

    app = ClusterBuilder().build_application(
        _spec(1, 1, n_items, work), backend="cluster",
        launcher=InProcessLauncher(connect_timeout=10.0),
        allow_late_join=allow, job_timeout=60.0, **FAST,
    )
    runner = app.run_async()
    deadline = time.monotonic() + 30
    while app.host_loader is None or app.host_loader.stats.items_total < 3:
        assert time.monotonic() < deadline and app.error is None
        time.sleep(0.01)
    hl = app.host_loader
    stranger = threading.Thread(
        target=run_node, args=("127.0.0.1", hl.port),
        kwargs={"node_id": "stranger", "connect_timeout": 5.0}, daemon=True)
    stranger.start()
    runner.join(timeout=60)
    stranger.join(timeout=30)
    assert not runner.is_alive() and not stranger.is_alive()
    assert app.error is None
    assert app.result == sum(i + 1 for i in range(n_items))
    assert hl.stats.items_total == n_items
    assert hl.stats.duplicates_dropped == 0
    if allow:
        assert hl.stats.late_joins == 1
        assert hl.membership.nodes["stranger"].state == DONE
        assert hl.membership.nodes["stranger"].items_done > 0
    else:
        assert hl.stats.late_joins == 0
        assert "stranger" not in hl.membership.nodes
    assert app.orphaned() == []


def test_slow_launcher_prepare_does_not_trigger_spurious_respawns():
    """The silence clock must start when the barrier does, not when the
    launches were announced: a launcher whose prepare() (code sync) takes
    longer than respawn_after must not get its healthy, just-launched
    nodes respawned out from under it."""

    class SlowPrepare(InProcessLauncher):
        def prepare(self, connect_host, port):
            time.sleep(0.6)  # a code sync slower than respawn_after
            super().prepare(connect_host, port)

    app = ClusterBuilder().build_application(
        _spec(2, 1, 20, lambda x: x), backend="cluster",
        launcher=SlowPrepare(connect_timeout=10.0),
        max_respawns=2, respawn_after=0.25, register_timeout=10.0,
        job_timeout=60.0, **FAST,
    )
    assert app.run() == sum(range(20))
    assert app.host_loader.stats.respawns == 0
    assert app.orphaned() == []


def test_strict_barrier_still_raises_without_policy_relaxation():
    """No min_nodes / respawns -> a missing node fails the barrier with a
    TimeoutError."""
    launcher = FlakyLauncher(drop_first=["node1"], connect_timeout=5.0)
    app = ClusterBuilder().build_application(
        _spec(2, 1, 10, lambda x: x), backend="cluster",
        launcher=launcher, register_timeout=0.5, job_timeout=30.0, **FAST,
    )
    with pytest.raises(TimeoutError, match="registered"):
        app.run()
    assert app.orphaned() == []


# ---------------------------------------------------------------------------
# orphan hygiene and the default launcher
# ---------------------------------------------------------------------------


def test_start_failure_midway_reaps_already_launched_nodes():
    """If bootstrap raises after some launches, teardown still runs and
    reaps them."""

    class ExplodingLauncher(InProcessLauncher):
        def launch(self, node_id, *, avoid=()):
            if node_id == "node1":
                raise RuntimeError("fan-out exploded on node1")
            return super().launch(node_id, avoid=avoid)

    app = ClusterBuilder().build_application(
        _spec(2, 1, 10, lambda x: x), backend="cluster",
        launcher=ExplodingLauncher(connect_timeout=1.0),
        job_timeout=30.0, shutdown_grace=5.0, **FAST,
    )
    with pytest.raises(RuntimeError, match="fan-out exploded"):
        app.run()
    assert app.error is None  # raised synchronously, not via run_async
    assert "node0" in app.handles
    assert app.orphaned() == []


def test_local_launcher_is_the_default_and_unchanged():
    """No launcher option -> LocalLauncher subprocesses."""
    app = ClusterBuilder().build_application(
        _spec(1, 1, 10, lambda x: x), backend="cluster",
        job_timeout=60.0, **FAST,
    )
    assert app.run() == sum(range(10))
    assert isinstance(app.launcher, LocalLauncher)
    assert all(h.where == "local" for h in app.handles.values())
    assert app.orphaned() == []
