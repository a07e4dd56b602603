"""The port's peer data plane (``repro_torch.cluster.peer``) and the stage
knobs that steer it, on localhost sockets and the CPU.

Mirrors the tests of ``tests/test_peer.py`` that need neither the warm
service nor its broadcast blocks or chaos seam (none of which is ported
yet): stable hashing and routing tables, the peer server's intake gate,
route validation in the DSL (``route=``, ``key_fn=``), ``normalize_routes``
and ``verify_pipeline(routes=)`` — the last against the JAX package's state
counts — and the peer directory's IPv6 parsing.  The end-to-end cases run
the pipelines as one ``backend="cluster"`` job each (node-loaders as
threads, ``InProcessLauncher``): a peer hop relays no payload byte through
the host, the host-routed control does, a keyed shuffle, two chained peer
hops, and a node killed mid-run with items in the peer ledger, each
exactly-once.  Last, the per-stage ``prefetch=`` and ``flush_ms=`` knobs
reach the node's credit window and flush cadence.
"""

import threading
import time

import pytest

from repro.core.verify import verify_pipeline as jax_verify_pipeline
from repro_torch.cluster import peer
from repro_torch.cluster.deploy.inprocess import InProcessLauncher
from repro_torch.cluster.host_loader import HostLoader
from repro_torch.cluster.membership import NodeRecord
from repro_torch.cluster.wire import FrameType, dumps_code
from repro_torch.core.builder import ClusterBuilder
from repro_torch.core.dsl import Pipeline
from repro_torch.core.processes import EmitDetails, ResultDetails
from repro_torch.core.protocol import normalize_routes
from repro_torch.core.verify import verify_pipeline

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


def _plus_one(x):
    return x + 1


def _slow_plus_one(x):
    time.sleep(0.004)
    return x + 1


def _slower_plus_one(x):
    time.sleep(0.01)
    return x + 1


def _double(x):
    return x * 2


def _times_three(x):
    return x * 3


def _slow_times_three(x):
    time.sleep(0.004)
    return x * 3


def _two_stage(n, *, route="peer", key_fn=None, stage1=None, plus_nodes=1):
    """range -> double (2x2) -> +1 (the routed hop) -> sorted list."""
    return (Pipeline(host="127.0.0.1")
            .emit(_range_emit(n))
            .stage(_double, nodes=2, workers=2, name="double")
            .stage(stage1 or _plus_one, nodes=plus_nodes, workers=1,
                   name="plus", route=route, key_fn=key_fn)
            .collect(_list_collect())
            .build())


def _three_stage(n, *, stage1=None, stage2=None, plus_nodes=1):
    """range -> double -> +1 (peer hop) -> *3 (a second consecutive peer
    hop) -> sorted list: intermediate values never transit the host."""
    return (Pipeline(host="127.0.0.1")
            .emit(_range_emit(n))
            .stage(_double, nodes=2, workers=2, name="double")
            .stage(stage1 or _plus_one, nodes=plus_nodes, workers=1,
                   name="plus", route="peer")
            .stage(stage2 or _times_three, nodes=1, workers=1, name="tri",
                   route="peer")
            .collect(_list_collect())
            .build())


def _cluster(spec, **options):
    return ClusterBuilder().build_application(
        spec, backend="cluster", launcher=InProcessLauncher(),
        job_timeout=120.0, **{**FAST, **options})


# ---------------------------------------------------------------------------
# routing units
# ---------------------------------------------------------------------------


def test_stable_hash_deterministic_and_typed():
    for key in (0, -7, "band", b"raw", 3.5, None, True, (1, "a"), [2, 3]):
        assert peer.stable_hash(key) == peer.stable_hash(key)
    # bool must not collide with int 1 (both hash() to 1 in builtin terms)
    assert peer.stable_hash(True) != peer.stable_hash(1)
    assert peer.stable_hash("1") != peer.stable_hash(1)
    assert 0 <= peer.stable_hash("x") < 2 ** 64


def test_route_table_round_robin_rotates_preference():
    rt = peer.RouteTable({"1": {"targets": ["a", "b", "c"], "mode": "rr",
                               "key_fn": None}})
    assert rt.has(1) and not rt.has(0)
    orders = [rt.targets_for(1, object()) for _ in range(4)]
    # every call returns ALL targets (fallback walk), head rotating
    assert all(sorted(o) == ["a", "b", "c"] for o in orders)
    assert [o[0] for o in orders] == ["a", "b", "c", "a"]


def test_route_table_keyed_pins_by_stable_hash():
    blob = dumps_code(lambda v: v % 4)
    rt = peer.RouteTable({"2": {"targets": ["a", "b"], "mode": "keyed",
                               "key_fn": blob}})
    # same key -> same preference order, every time
    first = rt.targets_for(2, 5)
    assert all(rt.targets_for(2, 5) == first for _ in range(5))
    # the order is the full list, so a dead primary degrades to the next
    assert sorted(first) == ["a", "b"]
    assert first[0] == rt.targets_for(2, 9)[0]  # 5 % 4 == 9 % 4


def test_route_table_empty_and_unknown_stage():
    rt = peer.RouteTable({})
    assert rt.targets_for(0, 1) == []
    assert not rt.has(0)


def test_peer_server_intake_gate_applies_backpressure():
    """The intake gate runs on the reader thread before each PEER_ITEMS
    hand-off: while it blocks, nothing reaches the handler (the socket
    stops draining), and releasing it delivers everything in order."""
    server = peer.PeerServer("gateRecv", bind_host="127.0.0.1")
    server.start()
    got: list = []
    gate_open = threading.Event()
    server.set_on_items(lambda jid, items: got.extend(items))
    server.set_intake_gate(lambda n: gate_open.wait(10.0))
    client = peer.PeerClient(
        "gateSend", {"gateRecv": ("127.0.0.1", server.port)})
    try:
        client.send_items(1, "gateRecv", [{"id": 0, "s": 1, "obj": 0}])
        client.send_items(1, "gateRecv", [{"id": 1, "s": 1, "obj": 1}])
        time.sleep(0.1)
        assert got == []  # reader parked in the gate, nothing delivered
        gate_open.set()
        deadline = time.monotonic() + 5.0
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert [i["id"] for i in got] == [0, 1]
        assert server.counters()["peer_items_recv"] == 2
        assert client.items_sent == 2 and client.bytes_sent > 0
    finally:
        client.close()
        server.close()


# ---------------------------------------------------------------------------
# DSL + route validation
# ---------------------------------------------------------------------------


def test_dsl_rejects_bad_route_values():
    p = Pipeline(host="127.0.0.1").emit(_range_emit(4))
    with pytest.raises(ValueError, match="route must be"):
        p.stage(_plus_one, route="udp")
    with pytest.raises(ValueError, match="key_fn only applies"):
        p.stage(_plus_one, key_fn=lambda v: v)
    with pytest.raises(ValueError, match="first stage cannot"):
        p.stage(_plus_one, route="peer")


def test_peer_routed_hops_maps_receiving_stage_to_source_hop():
    spec = _two_stage(4, key_fn=None)
    assert set(spec.peer_routed_hops()) == {0}
    spec = _two_stage(4, route=None)
    assert spec.peer_routed_hops() == {}


def test_normalize_routes_accepts_adjacent_and_rejects_cyclic():
    assert normalize_routes([0, 1], nstages=3) == frozenset({0, 1})
    assert normalize_routes({0: 1}, nstages=2) == frozenset({0})
    assert normalize_routes(None, nstages=2) == frozenset()
    with pytest.raises(ValueError, match="cyclic peer route"):
        normalize_routes({1: 0}, nstages=3)
    with pytest.raises(ValueError, match="cyclic peer route"):
        normalize_routes({1: 1}, nstages=3)
    with pytest.raises(ValueError, match="skips"):
        normalize_routes({0: 2}, nstages=3)
    with pytest.raises(ValueError):
        normalize_routes([5], nstages=2)  # out of range


# ---------------------------------------------------------------------------
# CSP verification of peer-routed wirings, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shapes,n,routes", [
    ([(2, 1), (1, 1)], 3, [0]),
    ([(2, 1), (2, 1), (1, 1)], 2, [0, 1]),
], ids=["one-peer-hop", "keyed-shuffle-composition"])
def test_verify_peer_routed_pipeline_all_assertions(shapes, n, routes):
    """A peer hop reroutes the rendezvous but not the protocol: the full
    Listing-3 battery holds over the decentralised wiring, over the same
    state space the JAX package explores."""
    report = verify_pipeline(shapes, n, routes=routes)
    assert report.deadlock_free, report.summary()
    assert report.divergence_free, report.summary()
    assert report.terminates, report.summary()
    assert report.objects_delivered_exactly_once, report.summary()
    assert report.ok
    ref = jax_verify_pipeline(shapes, n, routes=routes)
    assert (report.num_states, report.num_transitions) == \
        (ref.num_states, ref.num_transitions)


def test_verify_peer_hop_is_a_channel_rename():
    """Same topology host-routed vs peer-routed: the hop rename must
    preserve the state space exactly (it relabels, never reorders)."""
    host = verify_pipeline([(2, 1), (1, 1)], 3)
    peered = verify_pipeline([(2, 1), (1, 1)], 3, routes=[0])
    assert peered.num_states == host.num_states
    assert peered.num_transitions == host.num_transitions


def test_verify_rejects_cyclic_peer_route_before_exploring():
    with pytest.raises(ValueError, match="cyclic peer route"):
        verify_pipeline([(2, 1), (1, 1), (1, 1)], 2, routes={1: 0})


# ---------------------------------------------------------------------------
# host control-plane units
# ---------------------------------------------------------------------------


def test_peer_dir_preserves_ipv6_addresses():
    """The peer directory derives a dialable ip from the node's observed
    'ip:port' address: the port split must come from the RIGHT (an IPv6
    ip contains colons) or every peer edge silently degrades to relay."""
    hl = HostLoader(_two_stage(4))
    try:
        hl.membership.register("n6", "::1:41234", peer_port=7001)
        hl.membership.register("n4", "10.0.0.5:555", peer_port=7002)
        hl.membership.register("nb", "[fe80::2]:99", peer_port=7003)
        hl.membership.register("noport", "127.0.0.1:1", peer_port=0)
        d = hl._peer_dir()
        assert d["n6"] == ("::1", 7001)
        assert d["n4"] == ("10.0.0.5", 7002)
        assert d["nb"] == ("fe80::2", 7003)
        assert "noport" not in d  # no data-plane port: not routable
    finally:
        hl._listener.close()


class _CapturingConn:
    def __init__(self):
        self.frames = []

    def send(self, frame):
        self.frames.append(frame)


def _load_payload(hl, node_id):
    rec = NodeRecord(node_id=node_id, index=0, address="127.0.0.1:1",
                     conn=_CapturingConn(), peer_port=0)
    hl._send_load(rec, hl._primary)
    hl._threads[-1].join(timeout=10)
    (frame,) = rec.conn.frames
    assert frame.ftype is FrameType.LOAD
    return frame.payload


def test_stage_knobs_resolve_into_each_nodes_load():
    """prefetch= and flush_ms= on a stage override the cluster-wide values
    in the LOAD of that stage's nodes only; key_fn= ships as the keyed
    routing table of the hop into its stage."""
    spec = (Pipeline(host="127.0.0.1")
            .emit(_range_emit(4))
            .stage(_double, nodes=2, workers=2, name="double",
                   prefetch=0, flush_ms=2.0)
            .stage(_plus_one, nodes=1, workers=3, name="plus", route="peer",
                   key_fn=lambda v: v % 2)
            .collect(_list_collect())
            .build())
    hl = HostLoader(spec, prefetch=5, flush_interval=0.01)
    try:
        first = _load_payload(hl, "node0")
        assert (first["workers"], first["prefetch"], first["flush_interval"]) \
            == (2, 0, 0.002)
        assert [e["stage"] for e in first["stages"]] == ["double"]
        route = first["peer"]["routes"]["0"]
        assert route["mode"] == "keyed" and route["key_fn"] is not None
        second = _load_payload(hl, "node2")
        assert (second["workers"], second["prefetch"],
                second["flush_interval"]) == (3, 5, 0.01)
        assert [e["stage"] for e in second["stages"]] == ["plus"]
    finally:
        hl._listener.close()


@pytest.mark.parametrize("prefetch", [0, 3])
def test_stage_prefetch_sets_the_nodes_credit_window(prefetch):
    """A node asks for workers + prefetch items up front: the host's first
    WORK_BATCH to it is exactly that window when the stream can fill it."""
    spec = (Pipeline(host="127.0.0.1")
            .emit(_range_emit(40))
            .stage(_slow_plus_one, nodes=1, workers=2, name="plus",
                   prefetch=prefetch, flush_ms=1.0)
            .collect(_list_collect())
            .build())
    app = _cluster(spec)
    assert app.run() == [i + 1 for i in range(40)]
    assert app.host_loader.stats.max_batch == 2 + prefetch
    assert app.orphaned() == []


# ---------------------------------------------------------------------------
# e2e: peer-routed jobs on the cluster backend
# ---------------------------------------------------------------------------


def test_peer_hop_relays_zero_payload_bytes_through_host():
    n = 40
    app = _cluster(_two_stage(n))
    assert app.run() == sorted(2 * i + 1 for i in range(n))
    st = app.host_loader.stats
    assert st.peer_forwarded == n
    assert st.host_relay_bytes == 0
    assert st.duplicates_dropped == 0
    assert app.orphaned() == []


def test_host_routed_hop_still_relays_and_counts_bytes():
    """The control: same pipeline without route='peer' moves every hop
    payload through the host, and the counter says so."""
    n = 20
    app = _cluster(_two_stage(n, route=None))
    assert app.run() == sorted(2 * i + 1 for i in range(n))
    st = app.host_loader.stats
    assert st.peer_forwarded == 0
    assert st.host_relay_bytes > 0
    assert app.orphaned() == []


def test_keyed_shuffle_partitions_and_matches():
    """Two receiving nodes, keyed by value parity: every value of one key
    lands on one node."""
    n = 30
    app = _cluster(_two_stage(n, key_fn=lambda v: v % 2, plus_nodes=2))
    assert app.run() == sorted(2 * i + 1 for i in range(n))
    st = app.host_loader.stats
    assert st.peer_forwarded == n
    assert st.host_relay_bytes == 0
    # every doubled value is even: one key, so one receiving node did it all
    items = {nid: rec.items_done
             for nid, rec in app.host_loader.membership.nodes.items()
             if nid in ("node2", "node3")}
    assert sorted(items.values()) == [0, n], items
    assert app.orphaned() == []


def test_chained_peer_hops_relay_zero_bytes_and_terminate():
    """Two consecutive route='peer' stages: a node's stage-s input arrives
    over a peer edge and its result leaves over another.  The host's
    exactly-once ledger must follow the item across both hops or the job
    deadlocks."""
    n = 40
    app = _cluster(_three_stage(n))
    assert app.run() == sorted(3 * (2 * i + 1) for i in range(n))
    st = app.host_loader.stats
    assert st.peer_forwarded == 2 * n  # both hops, every item
    assert st.host_relay_bytes == 0
    assert st.duplicates_dropped == 0
    assert app.orphaned() == []


def _kill_mid_run(app, node_id):
    """Kill ``node_id`` once it has delivered two items.  A one-shot node
    exits when its stage drains, so the killed stage's work function is
    slow enough (10 ms an item, some 30 items a node) that the node is
    still working when the kill lands."""
    runner = app.run_async()
    deadline = time.monotonic() + 30
    while True:
        assert time.monotonic() < deadline and app.error is None
        hl = app.host_loader
        rec = None if hl is None else hl.membership.nodes.get(node_id)
        if rec is not None and rec.items_done >= 2:
            break
        time.sleep(0.002)
    app.kill_node(node_id)
    runner.join(timeout=120)
    assert not runner.is_alive()
    if app.error is not None:
        raise app.error
    return app.result


def test_kill_node_mid_run_chained_peer_hops_exactly_once():
    """A mid-run kill while items sit mid-chain: the stranded ledger
    entries hold the last input the host saw (possibly several stages
    back), so recompute restarts there under the same ids and dedup keeps
    delivery exactly-once."""
    n = 60
    app = _cluster(_three_stage(n, stage1=_slower_plus_one,
                                stage2=_slow_times_three, plus_nodes=2))
    assert _kill_mid_run(app, "node2") == \
        sorted(3 * (2 * i + 1) for i in range(n))
    hl = app.host_loader
    assert hl.stats.deaths_detected == 1, hl.membership.describe()
    assert hl.stats.items_total == n
    assert app.orphaned() == []


def test_kill_peer_target_mid_run_exactly_once():
    """Killing a node that receives peer-forwarded items mid-run: the host
    requeues its peer-ledger items upstream under the same ids, survivors
    recompute, and dedup keeps delivery exactly-once."""
    n = 80
    app = _cluster(_two_stage(n, stage1=_slower_plus_one, plus_nodes=2))
    assert _kill_mid_run(app, "node2") == \
        sorted(2 * i + 1 for i in range(n))
    hl = app.host_loader
    assert hl.stats.deaths_detected == 1, hl.membership.describe()
    assert hl.stats.items_total == n
    assert hl.stats.host_relay_bytes == 0
    assert app.orphaned() == []
