"""Roofline analysis per (architecture x shape), single-pod mesh.

Each cell's step is traced once on the 16 x 16 fake mesh
(``launch.dryrun.build_cell``), and the terms come from that trace:

    compute    = FLOPs_per_device / PEAK_FLOPS_BF16
    memory     = bytes_per_device / HBM_BW
    collective = sum over collectives of ring link bytes / link_bw(group)

on the H100's constants (``launch.mesh``: 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, NVLink 4 at 450 GB/s a direction within an 8-GPU node,
one 400 Gb/s NDR port, 50 GB/s, for a group that spans nodes).

The JAX package reconstructs totals from unrolled probe programs, because
XLA's ``cost_analysis`` counts a ``while``/scan body once (``_combine``,
``probe_cfg``, the sLSTM correction).  Eager dispatch has no such loops:
the trace runs every layer, every chunk and every sLSTM time step, so one
trace of the full-depth step gives the totals and none of that
reconstruction is needed.

``MODEL_FLOPS`` = 6 N_active D (train) / 2 N_active D (+ cache reads for
decode); ``roofline_fraction`` = time(MODEL_FLOPS at peak) / max(term) is
the MFU upper bound the traced program permits.  Results are JSON files
under ``build/repro_torch/roofline/`` (or ``--out``)::

    python -m repro_torch.launch.roofline --arch yi-9b --shape decode_32k
    python -m repro_torch.launch.roofline --render
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import all_cells, get_config, get_shape
from repro_torch.core.builder import ClusterBuilder
from repro_torch.launch.dryrun import check_device, build_cell
from repro_torch.launch.mesh import (
    HBM_BW,
    PEAK_FLOPS_BF16,
    link_bw,
    make_production_mesh,
    model_axis_size,
)
from repro_torch.models.flops import step_flops

OUT_DIR = os.path.join("build", "repro_torch", "roofline")


def analyze(cfg: ModelConfig, shape: ShapeConfig, mesh, mesh_name: str) -> dict:
    """The roofline of one cell traced on ``mesh``."""
    chips = mesh.size()
    tp = model_axis_size(mesh)
    t0 = time.perf_counter()
    fn, args, rules, _tp = build_cell(cfg, shape, mesh)
    art = ClusterBuilder(mesh=mesh, rules=rules).build_step(fn, args,
                                                            name="roofline")
    cost = art.cost()
    colls = art.collectives()
    flops = cost["flops_per_device"]
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = cost["bytes_per_device"] / HBM_BW
    t_coll = sum(op.link_bytes / link_bw(op.group_size) for op in colls.ops)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]

    fl = step_flops(cfg, shape, tp=tp)
    t_model = (fl.model_flops / chips) / PEAK_FLOPS_BF16
    traced_flops_global = flops * chips
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": shape.kind,
        "ok": True,
        "analysis_s": round(time.perf_counter() - t0, 1),
        "probes": 1,
        "flags": [],
        "per_device": {
            "flops": flops,
            "bytes": cost["bytes_per_device"],
            "collective_link_bytes": colls.total_link_bytes,
        },
        "terms_seconds": {k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant,
        "model_flops_global": fl.model_flops,
        "hlo_flops_global": traced_flops_global,
        "useful_ratio": round(fl.model_flops / max(traced_flops_global, 1), 4),
        "roofline_fraction": round(t_model / max(bound, 1e-12), 4),
        "collectives_by_kind": {
            k: {"count": n, "link_MiB": round(b / 2**20, 2)}
            for k, (n, b) in colls.by_kind().items()
        },
    }


def analyze_cell(arch: str, shape_name: str, device_type: str = "cuda") -> dict:
    shape = get_shape(shape_name)
    check_device(device_type)
    mesh = make_production_mesh(multi_pod=False, device_type=device_type)
    return analyze(get_config(arch), shape, mesh, "16x16")


def render_table(out_dir: str) -> str:
    rows = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as fh:
                rows.append(json.load(fh))
    lines = [
        f"{'arch':<28}{'shape':<13}{'compute_s':>11}{'memory_s':>11}"
        f"{'coll_s':>11}{'dominant':>11}{'useful':>8}{'roofline':>9}",
    ]
    for r in rows:
        if not r.get("ok"):
            lines.append(f"{r['arch']:<28}{r['shape']:<13}  FAILED: {r.get('error','')[:60]}")
            continue
        t = r["terms_seconds"]
        lines.append(
            f"{r['arch']:<28}{r['shape']:<13}{t['compute']:>11.4f}"
            f"{t['memory']:>11.4f}{t['collective']:>11.4f}"
            f"{r['dominant']:>11}{r['useful_ratio']:>8.3f}"
            f"{r['roofline_fraction']:>9.3f}"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type of the fake tensors")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.render and not (args.all or args.arch):
        print(render_table(args.out))
        return

    if args.all:
        cells = [(cfg.name, shape.name)
                 for cfg, shape, runnable in all_cells() if runnable]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all/--render")
        cells = [(args.arch, args.shape)]

    for arch, shape_name in cells:
        tag = f"{arch}__{shape_name}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[cached] {tag}")
            continue
        print(f"[roofline] {tag} ...", flush=True)
        try:
            result = analyze_cell(arch, shape_name, args.device)
            t = result["terms_seconds"]
            print(
                f"  compute {t['compute']:.4f}s | memory {t['memory']:.4f}s | "
                f"collective {t['collective']:.4f}s -> {result['dominant']} "
                f"(useful {result['useful_ratio']:.3f}, "
                f"roofline {result['roofline_fraction']:.3f})",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001
            result = {
                "arch": arch, "shape": shape_name, "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
            print(f"  FAILED: {result['error']}", flush=True)
        with open(path, "w") as fh:
            json.dump(result, fh, indent=2)

    if args.render:
        print()
        print(render_table(args.out))


if __name__ == "__main__":
    main()
