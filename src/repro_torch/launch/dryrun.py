"""Multi-pod dry-run: trace every (architecture x shape x mesh) cell.

The JAX package lowers and compiles each cell against 512 placeholder XLA
devices.  Here each cell's step is traced once on a *fake* process group
of 256 or 512 ranks (``launch.mesh.make_production_mesh``) with fake
tensors: DTensors placed by the builder's rules whose local shards have
shapes and dtypes and no storage.  Per cell this proves, with zero
allocation and no launch:

* the builder-derived placements compose (every op has a sharding, every
  redistribution is a known collective),
* the program partitions onto 16x16 and 2x16x16 meshes,
* ``memory()`` -> per-device bytes (does it fit the card's HBM?),
* ``cost()``   -> per-device FLOPs and bytes (roofline numerators),
* the collective schedule (recorded from the traced local ops).

The fake process group is created in ``main``, never at import.  Results
are JSON files under ``build/repro_torch/dryrun/`` (or ``--out``)::

    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all

``--device`` is the fake tensors' device type (default ``cuda``: fake CUDA
tensors need no card, but they need a CUDA build of PyTorch, whose device
guards some ops call; on a CPU-only build pass ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import all_cells, get_config, get_shape
from repro_torch.core.builder import ClusterBuilder
from repro_torch.core.channels import rules_for_shape_kind
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import make_production_mesh, model_axis_size
from repro_torch.models.flops import step_flops
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import steps as steps_mod

OUT_DIR = os.path.join("build", "repro_torch", "dryrun")


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(step_fn, example_args, rules, tp) for one cell — shared with the
    roofline."""
    rules = rules_for_shape_kind(mesh, shape.kind)
    tp = model_axis_size(mesh)
    opt_cfg = AdamWConfig()
    if shape.kind == "train":
        fn = steps_mod.make_train_step(cfg, opt_cfg, tp=tp, rules=rules)
        p, o = steps_mod.train_state_structs(cfg, rules, tp, opt_cfg)
        b = steps_mod.batch_structs(cfg, shape, rules)
        args = (p, o, b, 0)
    elif shape.kind == "prefill":
        fn = steps_mod.make_prefill_step(cfg, tp=tp, rules=rules)
        p, _ = steps_mod.train_state_structs(cfg, rules, tp, opt_cfg)
        b = steps_mod.prefill_batch_structs(cfg, shape, rules)
        args = (p, b)
    else:  # decode / long
        fn = steps_mod.make_decode_step(cfg, tp=tp, rules=rules)
        p, _ = steps_mod.train_state_structs(cfg, rules, tp, opt_cfg)
        cache, tokens, cache_len = steps_mod.decode_input_structs(
            cfg, shape, rules, tp)
        args = (p, cache, tokens, cache_len)
    return fn, args, rules, tp


def check_device(device_type: str) -> None:
    if device_type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError(
            "fake CUDA tensors need a CUDA build of PyTorch; pass --device cpu "
            "on a CPU-only build")


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                device_type: str = "cuda") -> dict:
    shape = get_shape(shape_name)
    check_device(device_type)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    return analyze_cell(get_config(arch), shape, mesh,
                        "2x16x16" if multi_pod else "16x16")


def analyze_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, mesh_name: str) -> dict:
    """Trace one cell on ``mesh`` and report it (the JSON fields of the
    JAX package's dry-run)."""
    arch, shape_name = cfg.name, shape.name
    t0 = time.perf_counter()
    fn, args, rules, tp = build_cell(cfg, shape, mesh)
    builder = ClusterBuilder(mesh=mesh, rules=rules)
    art = builder.build_step(fn, args, name=f"{arch}/{shape_name}")
    load_s = time.perf_counter() - t0

    ma = art.memory()
    cost = art.cost()
    colls = art.collectives()
    chips = mesh.size()
    fl = step_flops(cfg, shape, tp=tp)
    hbm = mesh_mod.HBM_BYTES
    per_dev_bytes = (ma.argument_size_in_bytes + ma.temp_size_in_bytes
                     + ma.output_size_in_bytes - ma.alias_size_in_bytes)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": shape.kind,
        "ok": True,
        "load_compile_s": round(load_s, 2),
        "memory": {
            "argument_bytes_per_device": ma.argument_size_in_bytes,
            "temp_bytes_per_device": ma.temp_size_in_bytes,
            "output_bytes_per_device": ma.output_size_in_bytes,
            "alias_bytes_per_device": ma.alias_size_in_bytes,
            "live_bytes_per_device": per_dev_bytes,
            "fits_hbm": bool(per_dev_bytes <= hbm),
            "hbm_fraction": round(per_dev_bytes / hbm, 4),
        },
        # every layer and loop step is traced: these are totals
        "cost_analysis": cost,
        "collectives": {
            "by_kind": {
                k: {"count": n, "link_MiB_per_device": round(b / 2**20, 3)}
                for k, (n, b) in colls.by_kind().items()
            },
            "total_ops": len(colls.ops),
            "total_link_MiB_per_device": round(colls.total_link_bytes / 2**20, 3),
        },
        "model_flops_global": fl.model_flops,
        "params_total": fl.params_total,
        "params_active": fl.params_active,
    }


def _device_bytes() -> int:
    return torch.cuda.memory_allocated() if torch.cuda.is_available() else 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device type of the fake tensors")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        cells = [
            (cfg.name, shape.name, mp)
            for cfg, shape, runnable in all_cells()
            if runnable
            for mp in (False, True)
        ]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, args.multi_pod)]

    failures = 0
    for arch, shape_name, mp in cells:
        tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[cached] {tag}")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            before = _device_bytes()
            result = dryrun_cell(arch, shape_name, mp, args.device)
            # the trace allocates nothing on a card (none where there is none)
            result["device_bytes_before_after_peak"] = [
                before, _device_bytes(),
                torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0]
            mem = result["memory"]
            print(
                f"  ok in {result['load_compile_s']}s: "
                f"{mem['live_bytes_per_device'] / 2**30:.2f} GiB/device "
                f"(HBM {100 * mem['hbm_fraction']:.1f}%), "
                f"{result['collectives']['total_ops']} collectives, "
                f"flops/dev {result['cost_analysis']['flops_per_device']:.3e}",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001 - recorded per cell
            failures += 1
            result = {
                "arch": arch, "shape": shape_name,
                "mesh": "2x16x16" if mp else "16x16",
                "ok": False, "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
            print(f"  FAILED: {result['error']}", flush=True)
        with open(path, "w") as fh:
            json.dump(result, fh, indent=2)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")
    print("all requested dry-run cells traced")


if __name__ == "__main__":
    main()
