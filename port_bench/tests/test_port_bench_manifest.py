"""``BENCHMARK.json`` keeps to its format and limits, and every cell,
mix, configuration, driver, reference, metric and limit is found by name:
a new cell is new files and new entries only."""

import json
import re
import shutil

import pytest

from port_bench import cell as cell_mod
from port_bench.tests.small import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
WIDTH = re.compile(r"(_dim|_rank|_size)$|hidden|intermediate|latent|state|proj|"
                   r"^d_|d_ff|expan|experts_per_token|window")


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["port_bench"]
    assert all(not w.startswith("/") and ".." not in w for w in MANIFEST["command"])
    assert (ROOT / MANIFEST["command"][1]).is_file()
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_run_seconds_fits_the_full_check_of_24_cells():
    seconds = MANIFEST["run_seconds"]
    assert 1 <= seconds <= 51
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_keep_their_format():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(WORKLOADS)
        for w in m["workloads"]:  # each cell it names reports what it moves
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves_by_name(workload):
    cell = cell_mod.resolve(ROOT, workload)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer and all(hasattr(r, "read") for _m, r in cell.per_layer)
    assert cell.chips == 1 and hasattr(cell.driver, "run")
    assert hasattr(cell.reference, "train") and hasattr(cell.reference, "logits_at")
    assert cell.limits, "every cell has its limits file"


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_configuration_files_state_their_cuts(entry):
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert not [k for k in entry["reduced"] if WIDTH.search(k)]
    for key in entry["reduced"]:
        assert config["published"][key] != config[key]


def test_a_new_cell_is_new_files_and_entries_only(tmp_path):
    """A cell of a new configuration, mix and metric resolves from added
    files and entries, no file of the benchmark edited."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench")
    bench = tmp_path / "port_bench"
    config = json.loads((bench / "configs" / "yi-9b.json").read_text())
    config.update(num_layers=12, reduced=["num_layers"], published={"num_layers": 48})
    (bench / "configs" / "yi-9b-l12.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "docs-closed-c64.json").read_text())
    (bench / "traffic" / "docs-closed-c32.json").write_text(
        json.dumps(dict(mix, clients=32, slots=32)))
    (bench / "metrics" / "serve.ticks.py").write_text(
        "def read(trace, counts, config):\n    return counts.get('ticks')\n")
    (bench / "limits" / "yi-l12-serve-c32.json").write_text(
        json.dumps({"served_gap": {"limit": 1.0}}))
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "yi-9b-l12", "source": config["source"],
                                "file": "port_bench/configs/yi-9b-l12.json",
                                "reduced": ["num_layers"], "why": "test"})
    manifest["workloads"].append({"name": "yi-l12-serve-c32", "config": "yi-9b-l12",
                                  "traffic": "docs-closed-c32", "chips": 1, "why": "test"})
    for metric in manifest["end_to_end"]:
        if metric["name"] == "serve_tokens_per_s":
            metric["workloads"].append("yi-l12-serve-c32")
    manifest["per_layer"].append({"name": "serve.ticks", "unit": "ticks",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "serving engine",
                                  "moves": "serve_tokens_per_s",
                                  "workloads": ["yi-l12-serve-c32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    before = {p: p.read_bytes() for p in (ROOT / "port_bench").rglob("*.json")}
    cell = cell_mod.resolve(tmp_path, "yi-l12-serve-c32")
    assert cell.config["num_layers"] == 12 and cell.mix["clients"] == 32
    assert [m["name"] for m, _r in cell.per_layer] == ["serve.ticks"]
    assert cell.per_layer[0][1].read(None, {"ticks": 7}, cell.config) == 7
    assert cell.limits == {"served_gap": 1.0}
    assert before == {p: p.read_bytes() for p in (ROOT / "port_bench").rglob("*.json")}
