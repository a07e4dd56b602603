"""The port's deployment layer (``repro_torch.cluster.deploy``) and the
host's placement policy, on localhost sockets and the CPU.

Mirrors the tests of ``tests/test_deploy.py``: membership states, policy
validation, the node-loader's connect retry, and the policy end to end —
degraded start (``min_nodes``), respawn of a silent launch
(``max_respawns``, ``respawn_after``), late join mid-run (an announced
straggler, and a stranger under both settings of ``allow_late_join``), no
spurious respawn behind a slow ``prepare``, the strict barrier, teardown
after a fan-out that fails midway, ``launcher=`` and ``hosts=`` exclusive,
and ``LocalLauncher`` as the default.  The policy runs its node-loaders as
threads (``InProcessLauncher``) over the same TCP protocol.

The ``SSHLauncher`` cases run through a stub ``ssh`` executable that drops
the host name and runs the remote command here, so the whole fan-out path
(command assembly, env export, tar code sync, handle lifecycle, logs) runs
with real node-loader subprocesses; their results are held against the
same job on the JAX package's threads backend.  One case the port adds:
the ssh node env is ``torch_node_env``'s, pinning no platform and naming
the remote tree's ``src``.
"""

import socket
import stat
import sys
import threading
import time

import pytest

from repro.cluster.deploy.ssh import SSHLauncher as JaxSSHLauncher
from repro.core import builder as jax_builder
from repro.core import dsl as jax_dsl
from repro.core import processes as jax_proc
from repro_torch.cluster.deploy import (
    InProcessLauncher,
    LocalLauncher,
    PlacementPolicy,
    SSHLauncher,
)
from repro_torch.cluster.deploy.local import SRC_DIR, torch_node_env
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
# The ssh cases start real node-loader subprocesses and assert results, not
# deaths: 10 s of heartbeat silence, so a loaded machine cannot fake one.
SLACK = dict(heartbeat_interval=0.5, heartbeat_misses=20)


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
    job starts at full strength with the replacement doing real work.

    An item takes 0.1 s, so node0 alone would need 4 s for the job: the
    replacement gets items unless its LOAD is acked that much later than
    node0's (instant items could all go to node0 first on a loaded
    machine)."""

    def work(x):
        time.sleep(0.1)
        return 3 * x

    launcher = FlakyLauncher(drop_first=["node1"], connect_timeout=5.0)
    app = ClusterBuilder().build_application(
        _spec(2, 1, 40, work), backend="cluster",
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
    and answered credits immediately; results stay exactly-once.  An item
    takes 0.1 s, so items are still queued 3 s after node1's 0.9 s delay
    ends, and node1 gets some however late a loaded machine starts it."""
    n_items = 40
    launcher = InProcessLauncher(connect_timeout=10.0,
                                 delays={"node1": 0.9})

    def work(x):
        time.sleep(0.1)
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
    allow_late_join=False.  Either way the result is exactly-once.  An
    item takes 0.1 s, so an admitted stranger finds items queued for about
    3.7 s after it is started."""
    n_items = 40

    def work(x):
        time.sleep(0.1)
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


def test_launcher_and_hosts_are_mutually_exclusive():
    app = ClusterBuilder().build_application(
        _spec(1, 1, 1, lambda x: x), backend="cluster",
        launcher=InProcessLauncher(), hosts=["localhost"],
    )
    with pytest.raises(TypeError, match="not both"):
        app.start()


# ---------------------------------------------------------------------------
# SSHLauncher (stub ssh executes the remote command locally)
# ---------------------------------------------------------------------------


def _jax_sum(work, n_items):
    """The same summing job on the JAX package's threads backend."""
    spec = jax_dsl.ClusterSpec.simple(
        host="127.0.0.1", nclusters=1, workers_per_node=2,
        emit_details=jax_proc.EmitDetails(
            name="range", init=lambda limit: (0, limit), init_data=(n_items,),
            create=lambda s: ((None, s) if s[0] >= s[1]
                              else (s[0], (s[0] + 1, s[1])))),
        work_function=work,
        result_details=jax_proc.ResultDetails(
            name="sum", init=lambda: 0, collect=lambda a, x: a + x),
    )
    return jax_builder.ClusterBuilder().build_application(spec).run()


@pytest.fixture
def stub_ssh(tmp_path):
    """An ``ssh`` stand-in: drops the hostname, runs the command locally."""
    path = tmp_path / "stub-ssh"
    path.write_text("#!/bin/sh\n# stub ssh: argv = <host> <command>\n"
                    "shift\nexec sh -c \"$1\"\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_ssh_launcher_runs_cluster_through_stub_ssh(stub_ssh):
    """The full fan-out path — command assembly, env export, per-node ssh
    process, logs — against a stub ssh."""
    launcher = SSHLauncher(
        ["ws-a", "ws-b"], ssh_cmd=(stub_ssh,), ssh_opts=(),
        python=sys.executable, connect_timeout=30.0,
    )
    builder = ClusterBuilder()
    app = builder.build_application(
        _spec(2, 2, 30, lambda x: x * x), backend="cluster",
        launcher=launcher, job_timeout=120.0, **SLACK,
    )
    assert app.run() == _jax_sum(lambda x: x * x, 30)
    # Round-robin placement over the host pool, one ssh client per node.
    assert {h.where for h in app.handles.values()} == {"ssh:ws-a", "ssh:ws-b"}
    assert all(h.returncode == 0 for h in app.handles.values())
    assert any("node-loader done" in line
               for h in app.handles.values() for line in h.logs())
    assert app.orphaned() == []


def test_ssh_code_sync_tar_fallback_ships_src_tree(tmp_path, stub_ssh):
    """Without rsync the sync falls back to tar-over-ssh; the remote dir
    ends up with the src tree the node-loader needs."""
    remote_dir = tmp_path / "deployed"
    launcher = SSHLauncher(
        ["ws-a"], ssh_cmd=(stub_ssh,), ssh_opts=(),
        remote_dir=str(remote_dir), sync="tar",
    )
    launcher.prepare("127.0.0.1", 2000)
    assert launcher.synced_hosts == ["ws-a"]
    synced = remote_dir / "src" / "repro_torch" / "cluster" / "node_loader.py"
    assert synced.is_file()
    assert not list(remote_dir.glob("**/__pycache__"))
    assert not (remote_dir / "build").exists()  # src only, no built kernels
    # The launch command runs from the synced tree, not this checkout.
    cmd = launcher.remote_command("node0")
    assert f"cd {remote_dir}" in cmd
    assert f"PYTHONPATH={remote_dir}/src" in cmd


def test_ssh_launcher_end_to_end_from_synced_tree(tmp_path, stub_ssh):
    """Code sync + launch together: the node-loader actually executes out
    of the tar-synced copy."""
    remote_dir = tmp_path / "deployed"
    launcher = SSHLauncher(
        ["ws-a"], ssh_cmd=(stub_ssh,), ssh_opts=(),
        remote_dir=str(remote_dir), sync="tar",
        python=sys.executable, connect_timeout=30.0,
    )
    app = ClusterBuilder().build_application(
        _spec(1, 2, 20, lambda x: 2 * x), backend="cluster",
        launcher=launcher, job_timeout=120.0, **SLACK,
    )
    assert app.run() == _jax_sum(lambda x: 2 * x, 20)
    assert app.orphaned() == []


def test_ssh_respawn_avoids_the_machine_that_swallowed_the_launch(stub_ssh,
                                                                  tmp_path):
    """Respawn placement: the replacement launch steers clear of the host
    whose first launch went silent."""
    # A second "ssh" that eats the command: the remote machine accepts the
    # session but the node-loader never comes up.
    eater = tmp_path / "eating-ssh"
    eater.write_text("#!/bin/sh\nexit 0\n")
    eater.chmod(eater.stat().st_mode | stat.S_IXUSR)

    class FirstLaunchEaten(SSHLauncher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.eaten = False

        def launch(self, node_id, *, avoid=()):
            real_cmd = self.ssh_cmd
            if not self.eaten:
                self.eaten = True
                self.ssh_cmd = (str(eater),)
            try:
                return super().launch(node_id, avoid=avoid)
            finally:
                self.ssh_cmd = real_cmd

    launcher = FirstLaunchEaten(
        ["ws-bad", "ws-good"], ssh_cmd=(stub_ssh,), ssh_opts=(),
        python=sys.executable, connect_timeout=30.0,
    )
    app = ClusterBuilder().build_application(
        _spec(1, 1, 20, lambda x: x + 7), backend="cluster",
        launcher=launcher, max_respawns=1, respawn_after=0.4,
        register_timeout=15.0, job_timeout=120.0, **SLACK,
    )
    assert app.run() == _jax_sum(lambda x: x + 7, 20)
    hl = app.host_loader
    assert hl.stats.respawns == 1
    # node0 went to ws-bad and vanished; node0r2 avoided ws-bad.
    assert app.handles["node0"].where == "ssh:ws-bad"
    assert app.handles["node0r2"].where == "ssh:ws-good"
    assert app.orphaned() == []


def test_ssh_home_relative_remote_dir_stays_shell_expandable():
    """remote_dir='~/x' must reach the remote shell as "$HOME"/x — quoting
    the tilde would make cd/PYTHONPATH point at a literal './~' dir."""
    launcher = SSHLauncher(["ws"], remote_dir="~/cluster-app", sync="none")
    launcher.prepare("0.0.0.0", 2000)
    cmd = launcher.remote_command("node0")
    assert 'cd "$HOME"/cluster-app' in cmd
    assert 'PYTHONPATH="$HOME"/cluster-app/src' in cmd
    assert "'~" not in cmd


def test_ssh_explicit_connect_host_survives_prepare():
    """The host binds 0.0.0.0, the launcher carries the LAN-reachable
    address remote nodes must dial — prepare() must not clobber it with the
    (unroutable or loopback) bind address."""
    launcher = SSHLauncher(["ws"], connect_host="10.0.0.5")
    launcher.prepare("0.0.0.0", 2000)
    assert launcher.connect_host == "10.0.0.5"
    assert "--host 10.0.0.5" in launcher.remote_command("node0")
    # Unconfigured -> fall back to the bind address, loopback-resolved
    # (the ssh-to-localhost case).
    fallback = SSHLauncher(["ws"])
    fallback.prepare("0.0.0.0", 2000)
    assert fallback.connect_host == "127.0.0.1"


def test_ssh_node_env_pins_no_platform_and_names_the_remote_src():
    """The ssh node env is ``torch_node_env``'s with ``PYTHONPATH`` pointed
    at the remote tree: no platform pinned (the JAX package's launcher pins
    ``JAX_PLATFORMS=cpu``), no compile cache, and never this checkout's
    ``src`` on a synced remote."""
    launcher = SSHLauncher(["ws"], remote_dir="/srv/app", sync="none")
    launcher.prepare("127.0.0.1", 2000)
    assert launcher._remote_env() == {**torch_node_env(),
                                      "PYTHONPATH": "/srv/app/src"}
    cmd = launcher.remote_command("node0")
    assert "env PYTHONPATH=/srv/app/src " in cmd
    assert SRC_DIR not in cmd
    assert "JAX_" not in cmd and "CUDA_VISIBLE_DEVICES" not in cmd
    assert "-m repro_torch.cluster.node_loader" in cmd

    jax_launcher = JaxSSHLauncher(["ws"], remote_dir="/srv/app", sync="none")
    jax_launcher.prepare("127.0.0.1", 2000)
    assert "JAX_PLATFORMS=cpu" in jax_launcher.remote_command("node0")

    # A shared filesystem: this checkout's src first, then this path.
    shared = SSHLauncher(["ws"])
    shared.prepare("127.0.0.1", 2000)
    assert shared._remote_env()["PYTHONPATH"].split(":")[0] == SRC_DIR
