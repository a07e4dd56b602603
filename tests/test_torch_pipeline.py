"""The port's generalised spec API on the cluster backend, against the JAX
package's, on the CPU.

Mirrors the cluster cases of ``tests/test_pipeline.py``: a two-stage
pipeline over the process transport (its node-loaders run as threads here,
``InProcessLauncher``, over the same TCP protocol), deployment plans that
carry real addresses, the plan the cluster backend derives, and a work
function that mutates its ndarray input failing on the cluster backend as
it does on threads under ``readonly_delivery``.  The JAX package's threads
backend gives the expected results.
"""

import numpy as np
import pytest

from repro.core import builder as jax_builder
from repro.core import dsl as jax_dsl
from repro.core import processes as jax_proc
from repro_torch import quickstart as port_qs
from repro_torch.cluster.deploy.inprocess import InProcessLauncher
from repro_torch.core import builder as port_builder
from repro_torch.core import dsl as port_dsl
from repro_torch.core import processes as port_proc
from repro_torch.runtime.failures import WorkFunctionError

# Fast liveness settings for cluster-backend tests (as in test_torch_cluster).
FAST = dict(heartbeat_interval=0.1, heartbeat_misses=4)
PACKAGES = {"jax": (jax_builder, jax_dsl, jax_proc),
            "torch": (port_builder, port_dsl, port_proc)}


def _range_emit(proc, n):
    return proc.EmitDetails(
        name="range",
        init=lambda limit: (0, limit),
        init_data=(n,),
        create=lambda s: (None, s) if s[0] >= s[1] else (s[0], (s[0] + 1, s[1])),
    )


def _two_stage(pkg, n_items=30):
    _, dsl, proc = PACKAGES[pkg]
    return (dsl.Pipeline(host="127.0.0.1")
            .emit(_range_emit(proc, n_items))
            .stage(lambda x: x * x, nodes=2, workers=2, name="square")
            .stage(lambda x: x + 1, nodes=1, workers=1, name="inc")
            .collect(proc.ResultDetails(name="sum", init=lambda: 0,
                                        collect=lambda a, x: a + x))
            .build())


def test_two_stage_pipeline_matches_on_cluster_backend():
    """The same two-stage spec, zero changes, over the process transport:
    the JAX package's result, per-stage routing stats, exactly-once, clean
    shutdown."""
    n = 30
    expected = jax_builder.ClusterBuilder().build_application(
        _two_stage("jax", n)).run()
    assert expected == sum(i * i + 1 for i in range(n))

    builder = port_builder.ClusterBuilder()
    app = builder.build_application(
        _two_stage("torch", n), backend="cluster", launcher=InProcessLauncher(),
        job_timeout=60.0, **FAST)
    assert app.run() == expected

    stats = app.host_loader.stats
    assert stats.items_total == n
    assert stats.forwarded == n
    assert stats.duplicates_dropped == 0 and stats.deaths_detected == 0
    assert len(app.processes) == 3
    assert app.orphaned() == []
    items = {t.node_id: t.items for t in builder.timing.nodes
             if t.node_id.startswith("node")}
    assert items["node0"] + items["node1"] == n
    assert items["node2"] == n


def test_fluent_quickstart_on_cluster_backend_equals_threads():
    """The quickstart's fluent two-stage job: its work functions ship to the
    nodes and the counts are the threads backend's."""
    spec = port_qs.fluent_spec(300, 16, 100, device="cpu")
    threaded = port_builder.ClusterBuilder().build_application(spec).run()
    app = port_builder.ClusterBuilder().build_application(
        port_qs.fluent_spec(300, 16, 100, device="cpu"), backend="cluster",
        launcher=InProcessLauncher(), job_timeout=60.0, **FAST)
    assert app.run() == threaded
    assert threaded["points"] == 300 * 16


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_deployment_plan_derives_real_addresses(pkg):
    builder_mod, dsl, proc = PACKAGES[pkg]
    spec = dsl.ClusterSpec.simple(
        host="192.168.1.176", nclusters=3, workers_per_node=1,
        emit_details=_range_emit(proc, 3), work_function=lambda x: x,
        result_details=proc.ResultDetails(name="sum", init=lambda: 0,
                                          collect=lambda a, x: a + x),
    )
    builder = builder_mod.ClusterBuilder()
    plan = builder.deployment_plan(spec, hosts=["ws01", "ws02"])
    assert [n.address.split(":")[0] for n in plan.nodes] == [
        "ws01", "ws02", "ws01"
    ]

    class FakeLauncher:
        hosts = ["wsA"]

    plan = builder.deployment_plan(spec, launcher=FakeLauncher())
    assert all(n.address.startswith("wsA:") for n in plan.nodes)
    plan = builder.deployment_plan(spec, bind_host="0.0.0.0")
    assert all(n.address.startswith("127.0.0.1:") for n in plan.nodes)
    plan = builder.deployment_plan(spec)
    assert plan.nodes[0].address.startswith("192.168.1.100:")
    # and the two packages describe every such plan alike
    other = PACKAGES["jax" if pkg == "torch" else "torch"][0].ClusterBuilder()
    for kw in ({"hosts": ["ws01", "ws02"]}, {"bind_host": "10.0.0.9"}, {}):
        assert builder.deployment_plan(spec, **kw).describe() == \
            other.deployment_plan(spec, **kw).describe()


def test_cluster_backend_plan_reflects_deployment():
    app = port_builder.ClusterBuilder().build_application(
        _two_stage("torch", 4), backend="cluster"
    )
    # never started: just inspect the derived plan
    assert all(n.address.startswith("127.0.0.1:") for n in app.plan.nodes)
    assert app.processes == {}


# ---------------------------------------------------------------------------
# readonly delivery (threads/cluster semantic parity)
# ---------------------------------------------------------------------------


def _array_spec(work, n=4, workers=1):
    emit = port_proc.EmitDetails(
        name="arrays",
        init=lambda limit: (0, limit),
        init_data=(n,),
        create=lambda s: ((None, s) if s[0] >= s[1]
                          else (np.full(4, float(s[0])), (s[0] + 1, s[1]))),
    )
    return port_dsl.ClusterSpec.simple(
        host="127.0.0.1", nclusters=1, workers_per_node=workers,
        emit_details=emit, work_function=work,
        result_details=port_proc.ResultDetails(
            name="sum", init=lambda: 0.0, collect=lambda a, x: a + x),
    )


def _cluster_app(spec):
    return port_builder.ClusterBuilder().build_application(
        spec, backend="cluster", launcher=InProcessLauncher(),
        job_timeout=60.0, **FAST)


def test_cluster_delivery_hands_out_immutable_views():
    """What the builder promises: ndarray payloads reach a node's work
    function as read-only views, as under readonly_delivery on threads."""

    def probe(x):
        assert isinstance(x, np.ndarray)
        return 0.0 if x.flags.writeable else 1.0

    assert port_builder.ClusterBuilder().build_application(
        _array_spec(probe, 6, 2)).run() == 0.0
    assert port_builder.ClusterBuilder().build_application(
        _array_spec(probe, 6, 2), readonly_delivery=True).run() == 6.0
    app = _cluster_app(_array_spec(probe, 6, 2))
    assert app.run() == 6.0
    assert app.orphaned() == []


def test_readonly_delivery_catches_cluster_mutation_bugs_single_host():
    """A work function that writes into its input passes on the default
    threads backend, fails with WorkFunctionError on the cluster backend's
    wire, and fails the same way on threads under readonly_delivery."""

    def mutating(x):
        x[0] = -1.0  # in-place write
        return float(x.sum())

    port_builder.ClusterBuilder().build_application(_array_spec(mutating)).run()
    with pytest.raises(WorkFunctionError):
        port_builder.ClusterBuilder().build_application(
            _array_spec(mutating), readonly_delivery=True).run()
    app = _cluster_app(_array_spec(mutating))
    with pytest.raises(WorkFunctionError, match="read-only"):
        app.run()
    assert app.orphaned() == []
