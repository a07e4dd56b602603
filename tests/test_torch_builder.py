"""The port's spec → verify → plan → threads-backend path against the JAX
package's, on the CPU.

The JAX side is the JAX package's own quickstart (``examples/quickstart.py``)
loaded at a small instance; the port's is ``repro_torch.quickstart`` at the
same instance with ``device="cpu"``.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import builder as jax_builder
from repro.core import dsl as jax_dsl
from repro.core import processes as jax_proc
from repro.core import verify as jax_verify
from repro.runtime import failures as jax_failures
from repro_torch import quickstart as port_qs
from repro_torch.core import builder as port_builder
from repro_torch.core import dsl as port_dsl
from repro_torch.core import processes as port_proc
from repro_torch.core import verify as port_verify
from repro_torch.runtime import failures as port_failures

ROOT = Path(__file__).resolve().parents[1]
WIDTH, LINES, ITERS = 300, 32, 100

JAX = SimpleNamespace(builder=jax_builder, dsl=jax_dsl, proc=jax_proc,
                      verify=jax_verify, failures=jax_failures)
PORT = SimpleNamespace(builder=port_builder, dsl=port_dsl, proc=port_proc,
                       verify=port_verify, failures=port_failures)
BOTH = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "torch"])


@pytest.fixture(scope="module")
def jax_qs():
    """The JAX package's quickstart module, sized by its environment knobs."""
    knobs = {"QUICKSTART_WIDTH": str(WIDTH), "QUICKSTART_LINES": str(LINES),
             "QUICKSTART_ITERS": str(ITERS)}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in knobs.items():
            mp.setenv(k, v)
        spec = importlib.util.spec_from_file_location(
            "jax_quickstart", ROOT / "examples" / "quickstart.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _jax_spec(jax_qs):
    return jax_dsl.parse_cgpp(
        jax_qs.SPEC % {"iters": ITERS, "width": WIDTH, "lines": LINES},
        namespace={"CALCULATE": jax_qs.calculate,
                   "COLLECTOR": jax_qs.collector})


def _port_spec():
    return port_qs.mandelbrot_spec(WIDTH, LINES, ITERS, device="cpu")


def test_quickstart_spec_text_is_the_jax_one(jax_qs):
    assert port_qs.SPEC == jax_qs.SPEC


def test_parsed_spec_shapes_agree(jax_qs):
    j, t = _jax_spec(jax_qs), _port_spec()
    assert isinstance(t, port_dsl.ClusterSpec)
    assert (t.host, t.nclusters, t.workers_per_node) == (
        j.host, j.nclusters, j.workers_per_node)
    # sections are evaluated against the port's own record classes
    assert isinstance(t.as_pipeline().emit, port_proc.Emit)


@pytest.mark.parametrize("num_objects", [2, 4])
def test_verification_agrees(jax_qs, num_objects):
    rj = jax_verify.verify_spec(_jax_spec(jax_qs), num_objects=num_objects)
    rt = port_verify.verify_spec(_port_spec(), num_objects=num_objects)
    assert rt.ok and rj.ok
    assert (rt.num_states, rt.num_transitions) == (rj.num_states, rj.num_transitions)
    assert rt.summary() == rj.summary()


@pytest.mark.parametrize("kind", ["cgpp", "staged-cgpp"])
def test_deployment_plan_agrees(jax_qs, kind):
    if kind == "cgpp":
        sj, st = _jax_spec(jax_qs), _port_spec()
    else:
        sj, st = (pkg.dsl.parse_cgpp(_staged_text(3)) for pkg in (JAX, PORT))
    pj = jax_builder.ClusterBuilder().deployment_plan(sj)
    pt = port_builder.ClusterBuilder().deployment_plan(st)
    assert pt.describe() == pj.describe()
    assert pt.load_order() == pj.load_order()


# -- the spec front end and the CSP check, both packages ----------------------


def _staged_text(n):
    return (
        "clusters = 2\n//@emit 10.0.0.1\n"
        f"d = DataDetails(name='r', init=lambda n: (0, n), init_data=({n},),\n"
        "    create=lambda s: (None, s) if s[0] >= s[1] else (s[0], (s[0]+1, s[1])))\n"
        "emit = Emit(e_details=d)\n"
        "//@stage square clusters\n"
        "group = AnyGroupAny(workers=2, function=lambda x: x * x)\n"
        "//@stage inc 1\n"
        "group = AnyGroupAny(workers=1, function=lambda x: x + 1)\n"
        "//@collect\n"
        "rd = ResultDetails(name='sum', init=lambda: 0, collect=lambda a, x: a + x)\n"
        "collector = Collect(r_details=rd)\n"
    )


def test_staged_cgpp_runs_like_jax():
    sj, st = (pkg.dsl.parse_cgpp(_staged_text(12)) for pkg in (JAX, PORT))
    assert isinstance(st, port_dsl.PipelineSpec)
    assert [(s.name, s.nclusters, s.workers_per_node) for s in st.stages] == [
        (s.name, s.nclusters, s.workers_per_node) for s in sj.stages]
    assert port_verify.verify_spec(st).summary() == jax_verify.verify_spec(sj).summary()
    rt = port_builder.ClusterBuilder().build_application(st).run()
    assert rt == jax_builder.ClusterBuilder().build_application(sj).run()
    assert rt == sum(i * i + 1 for i in range(12))


_EMIT = "emit = Emit(e_details=DataDetails(name='e', create=lambda s: (None, s)))\n"
_COLLECT = "collector = Collect(r_details=ResultDetails(name='c', collect=lambda a, x: a))\n"


@pytest.mark.parametrize("text", [
    "x = 1\n//@cluster 2\n//@emit 1.2.3.4\n//@collect\n",
    "x = 1\n",
    "x = 1\n//@emit\n//@cluster 2\n//@collect\n",
    "//@emitter 1.2.3.4\n//@cluster 2\n//@collect\n",
    "x = 1\n//@emit 1.2.3.4\n//@collect\n//@cluster 2\n",
    "//@emit 1.2.3.4\nx = 1\n//@emit 5.6.7.8\n//@cluster 2\n//@collect\n",
    "//@emit 1.2.3.4\n//@cluster 2\nx = 1\n//@collect\n//@collect\n",
    "//@emit 1.2.3.4\n//@cluster 2\nx = 1\n",
    "//@emit 1.2.3.4\n//@stage a 1\n//@stage a 2\n//@collect\n",
    "//@emit 1.2.3.4\n//@stage a 1\n//@collect\n//@stage b 1\n",
    "//@emit 1.2.3.4\n//@cluster 2\n//@stage a 1\n//@collect\n",
    "//@emit 1.2.3.4\n" + _EMIT + "//@stage a nope\n//@collect\n",
    "//@emit 1.2.3.4\n" + _EMIT + "//@stage a 1\nx = 1\n//@collect\n" + _COLLECT,
])
def test_cgpp_errors_agree(text):
    with pytest.raises(SyntaxError) as ej:
        jax_dsl.parse_cgpp(text)
    with pytest.raises(SyntaxError) as et:
        port_dsl.parse_cgpp(text)
    assert str(et.value) == str(ej.value)


def _fluent_misuse(pkg, step):
    emit = pkg.proc.EmitDetails(name="e", create=lambda s: (None, s))
    coll = pkg.proc.ResultDetails(name="c", collect=lambda a, x: a)
    p = pkg.dsl.Pipeline(host="h")
    if step == "stage-before-emit":
        p.stage(abs)
    elif step == "two-emits":
        p.emit(emit).emit(emit)
    elif step == "duplicate-stage":
        p.emit(emit).stage(abs, name="a").stage(abs, name="a")
    elif step == "stage-after-collect":
        p.emit(emit).stage(abs).collect(coll).stage(abs)
    elif step == "no-collect":
        p.emit(emit).stage(abs).build()
    elif step == "zero-nodes":
        p.emit(emit).stage(abs, nodes=0).collect(coll).build()


@pytest.mark.parametrize("step", [
    "stage-before-emit", "two-emits", "duplicate-stage", "stage-after-collect",
    "no-collect", "zero-nodes",
])
def test_fluent_errors_agree(step):
    with pytest.raises(ValueError) as ej:
        _fluent_misuse(JAX, step)
    with pytest.raises(ValueError) as et:
        _fluent_misuse(PORT, step)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("shapes", [
    [(2, 1)], [(3, 2)], [(2, 2), (1, 1)], [(2, 1), (2, 1), (1, 1)],
], ids=str)
@pytest.mark.parametrize("literal", [False, True], ids=["corrected", "literal"])
def test_verify_pipeline_agrees(shapes, literal):
    """The corrected Listing 3 passes; the literal one never terminates
    (its server waits on a channel that does not exist), in both."""
    m = 3 if len(shapes) == 1 else 2
    rj = jax_verify.verify_pipeline(shapes, m, literal_paper_model=literal)
    rt = port_verify.verify_pipeline(shapes, m, literal_paper_model=literal)
    assert rt.ok is (not literal) and rt.terminates is (not literal)
    assert rt.summary() == rj.summary()
    assert (rt.num_states, rt.num_transitions) == (rj.num_states, rj.num_transitions)


def test_threads_job_counts_equal_jax(jax_qs):
    rj = jax_builder.ClusterBuilder().build_application(_jax_spec(jax_qs)).run()
    builder = port_builder.ClusterBuilder()
    rt = builder.build_application(_port_spec(), backend="threads").run()
    assert rt == rj
    assert rt["points"] == WIDTH * LINES
    items = sum(n.items for n in builder.timing.nodes if n.node_id.startswith("node"))
    assert items == LINES


def _jax_fluent_spec(jax_qs):
    """The JAX package's counterpart of ``port_qs.fluent_spec``."""
    emit = jax_proc.EmitDetails(
        name="Mdata", init=lambda n: (0, n), init_data=(LINES,),
        create=lambda s: (None, s) if s[0] >= s[1] else (s[0], (s[0] + 1, s[1])))

    def fold(acc, item):
        points, white, iters = item
        return {"points": acc["points"] + points, "white": acc["white"] + white,
                "black": acc["black"] + points - white,
                "total_iters": acc["total_iters"] + iters}

    return (jax_dsl.Pipeline(host="192.168.1.176").emit(emit)
            .stage(jax_qs.calculate, nodes=2, workers=2, name="render")
            .stage(jax_qs.reduce_line, nodes=1, workers=1, name="reduce")
            .collect(jax_proc.ResultDetails(
                name="Mcollect",
                init=lambda: dict(points=0, white=0, black=0, total_iters=0),
                collect=fold))
            .build())


def test_fluent_two_stage_pipeline_equals_jax(jax_qs):
    spec_j = _jax_fluent_spec(jax_qs)
    spec_t = port_qs.fluent_spec(WIDTH, LINES, ITERS, device="cpu")
    assert [(s.name, s.nclusters, s.workers_per_node) for s in spec_t.stages] == [
        (s.name, s.nclusters, s.workers_per_node) for s in spec_j.stages]
    assert port_verify.verify_spec(spec_t).summary() == \
        jax_verify.verify_spec(spec_j).summary()
    rj = jax_builder.ClusterBuilder().build_application(spec_j).run()
    rt = port_builder.ClusterBuilder().build_application(spec_t).run()
    assert rt == rj
    # the two-stage job sees exactly the cgpp job's lines
    assert rt == port_builder.ClusterBuilder().build_application(_port_spec()).run()


@pytest.mark.parametrize("specs", [
    lambda jq: (_jax_spec(jq), _port_spec()),
    lambda jq: (_jax_fluent_spec(jq),
                port_qs.fluent_spec(WIDTH, LINES, ITERS, device="cpu")),
    lambda jq: tuple(pkg.dsl.parse_cgpp(_staged_text(12)) for pkg in (JAX, PORT)),
], ids=["paper-cgpp", "fluent-two-stage", "staged-cgpp"])
def test_spec_shape_properties_equal_jax(jax_qs, specs):
    sj, st = specs(jax_qs)
    assert type(st).__name__ == type(sj).__name__
    if isinstance(st, port_dsl.ClusterSpec):
        assert st.total_workers == sj.total_workers
        sj, st = sj.as_pipeline(), st.as_pipeline()
    shape = ("nstages", "total_nodes", "total_workers")
    assert [getattr(st, k) for k in shape] == [getattr(sj, k) for k in shape]


def test_quickstart_main_on_cpu(capsys):
    result, fluent = port_qs.main(["--device", "cpu", "--width", "64",
                                   "--lines", "8", "--iters", "20"])
    assert result["points"] == 64 * 8 and fluent["points"] == 64 * 8
    out = capsys.readouterr().out
    assert "deadlock free            PASS" in out and "DeploymentPlan" in out


@pytest.mark.parametrize("call", [
    lambda: port_qs.mandelbrot_spec(8, 2, 5),
    lambda: port_qs.fluent_spec(8, 2, 5),
    lambda: port_qs.main(["--width", "8", "--lines", "2", "--iters", "5"]),
], ids=["spec", "fluent", "main"])
def test_job_builders_default_to_cuda(monkeypatch, call):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


# -- threads-backend semantics, both packages ---------------------------------


def _array_spec(pkg, fn, workers=2, n=6):
    emit = pkg.proc.EmitDetails(
        name="arrays", init=lambda limit: (0, limit), init_data=(n,),
        create=lambda s: ((None, s) if s[0] >= s[1]
                          else (np.full(4, float(s[0])), (s[0] + 1, s[1]))))
    return pkg.dsl.ClusterSpec.simple(
        host="127.0.0.1", nclusters=1, workers_per_node=workers,
        emit_details=emit, work_function=fn,
        result_details=pkg.proc.ResultDetails(
            name="sum", init=lambda: 0.0, collect=lambda a, x: a + x))


@BOTH
@pytest.mark.parametrize("readonly,expected", [(False, 0.0), (True, 6.0)])
def test_readonly_delivery(pkg, readonly, expected):
    def probe(x):
        return 0.0 if x.flags.writeable else 1.0

    app = pkg.builder.ClusterBuilder().build_application(
        _array_spec(pkg, probe), readonly_delivery=readonly)
    assert app.run() == expected


@BOTH
def test_mutation_under_readonly_delivery_raises_work_function_error(pkg):
    def mutating(x):
        x[0] = -1.0
        return float(x.sum())

    pkg.builder.ClusterBuilder().build_application(
        _array_spec(pkg, mutating, workers=1, n=4)).run()
    with pytest.raises(pkg.failures.WorkFunctionError, match="read-only"):
        pkg.builder.ClusterBuilder().build_application(
            _array_spec(pkg, mutating, workers=1, n=4),
            readonly_delivery=True).run()


@BOTH
def test_work_function_error_propagates(pkg):
    def bad(x):
        if float(x[0]) == 3.0:
            raise ValueError("item 3 is cursed")
        return 0.0

    app = pkg.builder.ClusterBuilder().build_application(_array_spec(pkg, bad))
    with pytest.raises(pkg.failures.WorkFunctionError, match="item 3 is cursed"):
        app.run()


@pytest.mark.parametrize("backend", ["cluster", "service"])
def test_process_backends_build_as_the_jax_package_does(backend, jax_qs):
    """The warm node pool (``backend="service"``) and the cluster backend's
    ssh fan-out (``hosts=``), once left for a later slice, build as the JAX
    package's do: the same application class over the same deployment
    plan (built, not started; ``tests/test_torch_service.py`` and
    ``tests/test_torch_deploy.py`` run them)."""
    options = {"hosts": ["ws01", "ws02"]} if backend == "cluster" else {}
    jax_app = jax_builder.ClusterBuilder().build_application(
        _jax_spec(jax_qs), backend=backend, **options)
    port_app = port_builder.ClusterBuilder().build_application(
        _port_spec(), backend=backend, **options)
    assert type(port_app).__name__ == type(jax_app).__name__
    assert port_app.plan.describe() == jax_app.plan.describe()
    if backend == "cluster":
        assert [n.address for n in port_app.plan.nodes] == \
            [n.address for n in jax_app.plan.nodes] == \
            ["ws01:2000/1", "ws02:2000/1"]


@pytest.mark.parametrize("backend,options,exc", [
    ("processes", {}, ValueError),
    ("threads", {"port": 0}, TypeError),
])
def test_bad_backend_arguments_raise_like_jax(jax_qs, backend, options, exc):
    with pytest.raises(exc) as ej:
        jax_builder.ClusterBuilder().build_application(
            _jax_spec(jax_qs), backend=backend, **options)
    with pytest.raises(exc) as et:
        port_builder.ClusterBuilder().build_application(
            _port_spec(), backend=backend, **options)
    assert str(et.value) == str(ej.value)
