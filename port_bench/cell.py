"""A cell of ``BENCHMARK.json`` and everything it names, found by name.

* ``configs[].file``: the configuration's sizes (JSON);
* ``port_bench/traffic/<traffic>.json``: the mix, whose ``kind`` names the
  driver ``port_bench/drivers/<kind>.py``;
* ``port_bench/reference/<family>.py``: the plain reference of the
  configuration's family;
* ``port_bench/metrics/<name>.py``: one reader per per-layer metric;
* ``port_bench/limits/<workload>.json``: the limits of ``correct``.

A later cell, mix, configuration or metric is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType


def load_module(path: Path, name: str) -> ModuleType:
    """A module from its file (metric names hold dots, so not by import)."""
    if not path.exists():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    driver: ModuleType
    reference: ModuleType
    end_to_end: list[dict]
    per_layer: list[tuple[dict, ModuleType]]
    limits: dict
    run_seconds: int


@dataclass
class Run:
    """One run of a cell: what the command line and the clock give."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"
    fault: str | None = None  # a planted fault (the tests' runs only)


def _applies(metric: dict, workload: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def resolve(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    from port_bench import checks

    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if entry is None:
        known = ", ".join(w["name"] for w in manifest["workloads"])
        raise KeyError(f"unknown workload {workload!r}; known: {known}")
    conf_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf_entry["file"]).read_text())
    bench = root / "port_bench"
    mix = json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text())
    driver = load_module(bench / "drivers" / f"{mix['kind']}.py",
                         f"port_bench.drivers.{mix['kind']}")
    reference = load_module(bench / "reference" / f"{config['family']}.py",
                            f"port_bench.reference.{config['family']}")
    end_to_end = [m for m in manifest["end_to_end"]
                  if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in end_to_end}
    per_layer = [(m, load_module(bench / "metrics" / f"{m['name']}.py",
                                 f"port_bench.metrics.{m['name']}"))
                 for m in manifest["per_layer"] if _applies(m, workload, reported)]
    return Cell(name=workload, chips=entry["chips"], config=config, mix=mix,
                driver=driver, reference=reference, end_to_end=end_to_end,
                per_layer=per_layer,
                limits=checks.load_limits(workload, bench / "limits"),
                run_seconds=manifest["run_seconds"])
