"""Render the dry-run and roofline tables from the port's result directories
(``build/repro_torch/dryrun`` and ``build/repro_torch/roofline`` by default,
where ``launch.dryrun`` and ``launch.roofline`` write them).

    python -m repro_torch.launch.report [all|dryrun|roofline]
"""

from __future__ import annotations

import json
import os

from repro_torch.configs.registry import all_cells
from repro_torch.launch.dryrun import OUT_DIR as DRYRUN_DIR
from repro_torch.launch.roofline import OUT_DIR as ROOFLINE_DIR


def _load(dirname: str) -> dict:
    out = {}
    if not os.path.isdir(dirname):
        return out
    for name in os.listdir(dirname):
        if name.endswith(".json"):
            with open(os.path.join(dirname, name)) as fh:
                r = json.load(fh)
            out[name[: -len(".json")]] = r
    return out


def dryrun_table(dir_=DRYRUN_DIR) -> str:
    res = _load(dir_)
    lines = [
        "| arch | shape | mesh | trace_s | GiB/device | HBM% | collectives | link MiB/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for cfg, shape, runnable in all_cells():
        for mesh, tag in (("16x16", "single"), ("2x16x16", "multi")):
            key = f"{cfg.name}__{shape.name}__{tag}"
            if not runnable:
                if tag == "single":
                    why = dict(cfg.skipped_shapes()).get(shape.name, "skip")
                    lines.append(
                        f"| {cfg.name} | {shape.name} | — | — | — | — | "
                        f"SKIP: {why[:60]} | — |"
                    )
                continue
            r = res.get(key)
            if r is None:
                lines.append(f"| {cfg.name} | {shape.name} | {mesh} | pending | | | | |")
            elif not r.get("ok"):
                lines.append(
                    f"| {cfg.name} | {shape.name} | {mesh} | FAILED | | | "
                    f"{r.get('error', '')[:50]} | |"
                )
            else:
                m = r["memory"]
                c = r["collectives"]
                lines.append(
                    f"| {cfg.name} | {shape.name} | {mesh} | "
                    f"{r['load_compile_s']} | "
                    f"{m['live_bytes_per_device'] / 2**30:.2f} | "
                    f"{100 * m['hbm_fraction']:.0f}% | "
                    f"{c['total_ops']} | "
                    f"{c['total_link_MiB_per_device']:.0f} |"
                )
    return "\n".join(lines)


def roofline_table(dir_=ROOFLINE_DIR) -> str:
    res = _load(dir_)
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "useful | roofline | one-line fix |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    fixes = {
        "collective": "cut cross-shard repartitions (constraint placement, "
                      "comm/compute overlap, grad compression on pod axis)",
        "memory": "larger per-step arithmetic intensity (fuse, bf16 cache, "
                  "batch more tokens per weight fetch)",
        "compute": "near bound — reduce padding waste / remat recompute",
    }
    for cfg, shape, runnable in all_cells():
        if not runnable:
            continue
        r = res.get(f"{cfg.name}__{shape.name}")
        if r is None:
            lines.append(f"| {cfg.name} | {shape.name} | pending | | | | | | |")
            continue
        if not r.get("ok"):
            lines.append(
                f"| {cfg.name} | {shape.name} | FAILED | | | | | | "
                f"{r.get('error', '')[:40]} |"
            )
            continue
        t = r["terms_seconds"]
        lines.append(
            f"| {cfg.name} | {shape.name} | {t['compute']:.4f} | "
            f"{t['memory']:.4f} | {t['collective']:.4f} | {r['dominant']} | "
            f"{r['useful_ratio']:.3f} | {r['roofline_fraction']:.4f} | "
            f"{fixes[r['dominant']][:70]} |"
        )
    return "\n".join(lines)


def main() -> None:
    import sys

    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "dryrun"):
        print("### Dry-run table\n")
        print(dryrun_table())
        print()
    if which in ("all", "roofline"):
        print("### Roofline table\n")
        print(roofline_table())


if __name__ == "__main__":
    main()
