"""Nothing the benchmark runs loads JAX or the JAX package ``repro``, and
the plain references load nothing of the program either.  Module names
are compared by their whole top-level name: ``repro_torch`` is the port."""

import ast
import json
import os
import subprocess
import sys

import pytest

from port_bench import run as run_mod
from port_bench.tests.small import ROOT

BENCH = ROOT / "port_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not FORBIDDEN & set(_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not (FORBIDDEN | {"repro_torch"}) & set(_imports(path))


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchx", sys)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    bad = run_mod.forbidden_modules()
    assert "repro.core" in bad and "repro_torchx" not in bad
    assert not [m for m in bad if m.startswith("repro_torch")]


_PROBE = """
import json, sys
sys.argv = ["run.py"]
sys.path[:0] = [{root!r}, {src!r}]
from port_bench import cell, run
for workload in {workloads!r}:
    c = cell.resolve(run.ROOT, workload)
print(json.dumps({{"forbidden": run.forbidden_modules(),
                   "loaded": sorted(m for m in sys.modules if m.startswith(("port_bench", "repro_torch")))}}))
"""


def test_a_fresh_interpreter_running_every_cell_loads_no_jax():
    workloads = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
    probe = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"), workloads=workloads)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300, check=True)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["forbidden"] == []
    assert "repro_torch.runtime.serving" in seen["loaded"]
    assert "repro_torch.runtime.steps" in seen["loaded"]
