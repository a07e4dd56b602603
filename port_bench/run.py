"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number that
decided ``correct`` with its limit, also printed as the last lines of
standard error.  Without a CUDA card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded once the window has
closed, the run exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is the port, not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"


def per_layer_metrics(cell, outcome: dict) -> dict:
    out = {}
    for metric, reader in cell.per_layer:
        value = reader.read(outcome["trace"], outcome["counts"], cell.config)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def result_line(cell, outcome: dict, traced: bool) -> dict:
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": outcome["memory_peak_bytes"]}
    out = {"correct": outcome["correct"], "attempted": outcome["attempted"],
           "failed": outcome["failed"]}
    if traced:
        tr = outcome["trace"]
        out["metrics"] = per_layer_metrics(cell, outcome)
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["device"] = device
        out["breakdown"] = tr.breakdown()
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        out["metrics"] = {k: {"value": v, "unit": units[k]}
                          for k, v in outcome["metrics"].items() if k in units}
        out["device"] = device
    out["checks"] = outcome["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from port_bench import cell as cell_mod

    cell = cell_mod.resolve(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}",
          file=sys.stderr)
    run = cell_mod.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), t_start=T_START)
    outcome = cell.driver.run(run)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    if args.trace:
        tr = outcome["trace"]
        print(f"trace: events {json.dumps(tr.event_kinds)}; device ops "
              f"{len(tr.ops)}, without a launch record {tr.unattributed}",
              file=sys.stderr)
    line = result_line(cell, outcome, bool(args.trace))
    print(f"counts: {json.dumps(_brief(outcome['counts']))}", file=sys.stderr)
    for name, c in outcome["checks"].items():
        verdict = "ok" if c["limit"] is not None and c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


def _brief(counts: dict) -> dict:
    """Counts for the log, long lists summed."""
    return {k: (len(v) if isinstance(v, list) else v) for k, v in counts.items()}


if __name__ == "__main__":
    sys.exit(main())
