"""Readings for the limits of ``correct``, and sweeps of a mix, in one
process on the card (set-up paid once):

    python3 port_bench/tools/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--faults a,b] [--seconds 8] [--trace] \
        [--mix clients=32 --mix slots=32] [--out readings.json]

For each of ``--seeds`` the cell runs as ``run.py`` runs it (a window of
``--seconds``) and its compared numbers are read: the lower readings.
For each of ``--control-seeds`` the control is read: the plain reference
in fp8 in the program's place (for a served cell, on the program's
requests of a run on that seed).  ``--faults`` runs the named planted
faults (``all``: the driver's every one) on the first three of
``--seeds``.  ``--mix`` overrides keys of the traffic mix (JSON values).
"""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from port_bench import cell as cell_mod  # noqa: E402
from port_bench import run as run_mod  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def _numbers(out: dict) -> dict:
    return {k: v["value"] for k, v in out["checks"].items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--mix", action="append", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()

    cell = cell_mod.resolve(ROOT, args.workload)
    for item in args.mix:
        key, _, value = item.partition("=")
        cell.mix[key] = json.loads(value)
    report = {"workload": args.workload, "mix": cell.mix, "card": run_mod.card_line(),
              "program": [], "control": [], "faults": []}

    def make(seed, fault=None, trace=False):
        return cell_mod.Run(cell=cell, seed=seed, seconds=args.seconds, trace=trace,
                            t_start=time.perf_counter(), fault=fault)

    def emit(kind, row):
        report[kind].append(row)
        print(kind, json.dumps(row), flush=True)

    for seed in _seeds(args.seeds):
        out = cell.driver.run(make(seed, trace=args.trace))
        row = {"seed": seed, "numbers": _numbers(out), "metrics": out["metrics"],
               "attempted": out["attempted"], "failed": out["failed"],
               "memory_peak_bytes": out["memory_peak_bytes"]}
        row["readings"] = {k: v for k, v in out["readings"].items()
                           if k in ("program", "reference", "by_leaf", "gaps", "errors")}
        row["setup_phases_s"] = out["counts"].get("setup_phases_s")
        if args.trace:
            row["per_layer"] = run_mod.per_layer_metrics(cell, out)
            row["busy_s"], row["window_s"] = out["trace"].busy_s, out["trace"].window_s
        emit("program", row)
    for seed in _seeds(args.control_seeds):
        numbers = cell.driver.control_numbers(make(seed), "fp8")
        emit("control", {"seed": seed, "readings": numbers.pop("readings"),
                         "numbers": numbers})
    if args.faults:
        for seed in (_seeds(args.seeds) or _seeds(args.control_seeds) or [1])[:3]:
            names = args.faults.split(",")
            for fault in cell.driver.FAULTS if names == ["all"] else names:
                out = cell.driver.run(make(seed, fault))
                emit("faults", {"fault": fault, "seed": seed, "numbers": _numbers(out),
                                "readings": {k: v for k, v in out["readings"].items()
                                             if k in ("gaps", "errors")}})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
