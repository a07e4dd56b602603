"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX, Triton or any module of the JAX package ``repro``."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|triton|repro)(?:\.|\s|,|$)",
    re.MULTILINE,
)

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "repro"))
print(json.dumps({"modules": names, "forbidden": bad}))
"""


def test_every_port_module_imports_without_jax_triton_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["forbidden"] == []
    # every module of the slice was imported, the kernel's among them
    for name in ("repro_torch.core.builder", "repro_torch.runtime.local",
                 "repro_torch.kernels.mandelbrot.kernel",
                 "repro_torch.kernels.mandelbrot.ops", "repro_torch.quickstart",
                 "repro_torch.kernels.rmsnorm.kernel",
                 "repro_torch.kernels.rmsnorm.ops",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.rglru.kernel",
                 "repro_torch.kernels.rglru.ops",
                 "repro_torch.kernels.rglru.ref",
                 "repro_torch.models.recurrent",
                 "repro_torch.configs.registry", "repro_torch.models.common",
                 "repro_torch.models.convert", "repro_torch.models.layers",
                 "repro_torch.models.attention", "repro_torch.models.lm",
                 "repro_torch.runtime.steps", "repro_torch.runtime.serving",
                 "repro_torch.launch.serve", "repro_torch.serve_pipeline",
                 "repro_torch.runtime.failures", "repro_torch.core.timing",
                 "repro_torch.core.processes", "repro_torch.core.dsl",
                 "repro_torch.core.protocol", "repro_torch.core.verify",
                 "repro_torch.cluster", "repro_torch.cluster.wire",
                 "repro_torch.cluster.netchannels",
                 "repro_torch.cluster.membership",
                 "repro_torch.cluster.telemetry",
                 "repro_torch.cluster.telemetry.registry",
                 "repro_torch.cluster.telemetry.http",
                 "repro_torch.cluster.telemetry.dashboard",
                 "repro_torch.cluster.deploy", "repro_torch.cluster.deploy.base",
                 "repro_torch.cluster.deploy.local",
                 "repro_torch.cluster.deploy.inprocess",
                 "repro_torch.cluster.peer", "repro_torch.cluster.node_loader",
                 "repro_torch.cluster.host_loader", "repro_torch.cluster.spawn",
                 "repro_torch.optim.adamw", "repro_torch.optim.schedule",
                 "repro_torch.optim.compression", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.runtime.executor", "repro_torch.launch.train",
                 "repro_torch.train_lm",
                 "repro_torch.kernels.flash_attention.ref",
                 "repro_torch.kernels.rmsnorm.ref",
                 "repro_torch.kernels._shard",
                 "repro_torch.core.channels", "repro_torch.core.hlo",
                 "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
                 "repro_torch.launch.roofline", "repro_torch.launch.report",
                 "repro_torch.runtime.elastic", "repro_torch.models.flops"):
        assert name in seen["modules"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_names_no_forbidden_import(path):
    assert FORBIDDEN_IMPORT.findall(path.read_text()) == []


def test_forbidden_import_pattern():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import jit",
                 "from repro.core.dsl import parse_cgpp", "import repro",
                 "    from triton import language", "import jaxlib"):
        assert FORBIDDEN_IMPORT.search(line), line
    for line in ("from repro_torch.core.dsl import parse_cgpp",
                 "import repro_torch", "import torch", "# import jax? no"):
        assert not FORBIDDEN_IMPORT.search(line), line
