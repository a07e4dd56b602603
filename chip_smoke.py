"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's four CUDA kernels from ``src/repro_torch`` (one ``nvcc``
per source, all at once) and drives the port's paths on the card:

1. The paper's Mandelbrot job (3,200 lines x 5,600 points, escape value
   1,000, 2 clusters x 4 cores) parsed from ``.cgpp``, verified, planned and
   run on the threads backend, every line in one launch of the escape-time
   kernel's line entry.  First the grid entry is held against its plain
   version (exact equality), at the check shapes and at max_iters around
   the kernel's chunk of trips, and the line entry's sums against the grid
   entry's row sums on every row, the paper's 3,200 lines among them; the
   work function is profiled, after the serving phases, to show its two
   device launches an item.  Then the same parsed spec runs on the
   ``cluster`` backend (``job_cluster``): 2 node-loader subprocesses x 4
   workers, each process with its own CUDA context, every line one launch
   of the line entry inside a node; in turns with the threads job
   (threads, cluster, cluster, threads), each run's counts equal to the
   full grid's.  Then the same spec as jobs of a warm pool
   (``job_service``): 2 node-loader subprocesses x 4 workers booted once,
   the spec submitted three times back to back (the second and third ship
   no code and pay no boot), twice at once, and once more with a node
   killed mid-job and healed by a relaunch; every job's counts equal to the
   full grid's, every node's line-kernel launches equal to its items.
2. LM serving, dense: the fused RMS-norm, flash-attention (both variants:
   wgmma for bfloat16, CUDA cores for float32) and RG-LRU scan kernels are
   held against their plain versions (RMS norm also bit-equal on the same
   rows in launches of 1, 4 and 1,000 rows; the chunked RG-LRU scan within
   tolerance of the sequential scan and bit-equal to ``rglru_scan_chunked``,
   S around its chunk length among the cases); then ``ServingEngine``
   serves yi-9b at full width, first cut to 4 layers in float32 (every
   completion must equal offline greedy decode), then at full depth (48
   layers, bf16 weights from ``init_params`` on the card), where the
   kernels' launches are counted.
3. LM serving, recurrent: the same for recurrentgemma-2b (RG-LRU and
   sliding-window attention, window 2048), cut to one period of 3 layers
   in float32, then at full depth (26 layers, bf16), with prompts longer
   than the window so that the local layers' ring wraps, and its serving
   run repeated under ``torch.profiler`` to see where the device time goes.

Each phase prints one JSON line; any failure exits non-zero.  The line
before the last lists every kernel with its launches on its path, its
device time at that path's shapes, its bound, its plain version's time and
a library call's (RMS norm and RG-LRU also split into their prefill and
decode-tick launches, beside the time of as many launches at the least
shape); the last line is the run's verdict.

Without a CUDA device, or without the repository around it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import importlib.metadata
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script measures the card only")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.cluster.deploy.local import LocalLauncher, _child_env  # noqa: E402
from repro_torch.cluster.service import ClusterService  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.core.builder import ClusterBuilder  # noqa: E402
from repro_torch.core.verify import verify_spec  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.kernels.mandelbrot import kernel as mandel_kernel  # noqa: E402
from repro_torch.kernels.mandelbrot.ops import mandelbrot_line_stats  # noqa: E402
from repro_torch.kernels.mandelbrot.ref import (  # noqa: E402
    grid_coords,
    mandelbrot_reference,
)
from repro_torch.kernels.rglru import kernel as rglru_kernel  # noqa: E402
from repro_torch.kernels.rglru.ref import (  # noqa: E402
    rglru_scan_chunked,
    rglru_scan_reference,
)
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rms_norm_reference  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import recurrent as rec_mod  # noqa: E402
from repro_torch.models.common import count_params, init_params  # noqa: E402
from repro_torch.core.dsl import parse_cgpp  # noqa: E402
from repro_torch.quickstart import (  # noqa: E402
    LINES,
    MAX_ITERATIONS,
    SPEC,
    WIDTH,
    Calculate,
    backend_options,
    collector,
    fluent_spec,
    make_calculate,
    mandelbrot_spec,
)
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serve_pipeline import offline_greedy  # noqa: E402

# H100 SXM: 132 SMs of 128 FP32 lanes; HBM3 at 3.35 TB/s; dense bf16 tensor
# cores at 989 TFLOP/s; FP32 outside the tensor cores 67 TFLOP/s (NVIDIA
# data sheet).
SMS = 132
FP32_LANES = 128
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
# FP32 instructions per live iteration: two squares, the escape test's add
# and compare, 2*zx, the two fmas, the add of x0 (csrc/mandelbrot.cu).
INSTR_PER_ITER = 8
BYTES_PER_POINT = 16  # two f32 coordinates in, two i32 results out
# Cycles of one trip's dependent chain (zy^2 -> fma -> +x0, three FP32
# operations of 4 cycles): a line takes at least its slowest point's count
# times this, however many SMs it spreads over.
TRIP_LATENCY_CYCLES = 12

# Per-line timing: launches per chunk (well inside the stream's queue of
# pending launches) and the spin that holds the stream while they enqueue.
LINE_CHUNK = 200
SPIN_S = 0.05
CALL_CHUNK = 32  # calls per chunk when timing the serving kernels
START = time.perf_counter()

CHECK_SHAPES = [(9, 77, 30), (32, 300, 100), (64, 700, 1000), (1, WIDTH, 1000)]
# Shapes checked again at max_iters 0, 1, K - 1, K, K + 1 and 1000, where K is
# the kernel's chunk of trips between escape branches.
K_EDGE_SHAPES = [(1, WIDTH), (64, 700)]
PROFILED_ITEMS = 100  # work items under torch.profiler

# RMS norm checks: [N, D], and the (x, scale) dtypes the model passes it;
# yi-9b's D = 4096 and recurrentgemma-2b's D = 2560 at a tick's 4 rows, a
# prompt's and one row.
RMS_SHAPES = [(9, 77), (128, 4096), (1000, 4096), (4, 4096), (1, 4096),
              (4, 2560), (3000, 2560)]
# Row invariance: the first rows of a [1000, D] launch, normalised again in
# launches of 1 and 4 rows, must come out the same bits, at both served D.
RMS_INVARIANCE_ROWS, RMS_SERVED_D = (1, 4, 1000), (4096, 2560)
RMS_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16)]
RMS_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
# Flash checks (b, h, kv, sq, skv, d, causal, window): the reference sweep of
# tests/test_kernels.py, yi-9b's prefill shapes (read in place from the
# model's [B, S, H, D] layout), and the head dims and cross lengths that
# only other configs reach.
FLASH_SWEEP = [(2, 4, 4, 256, 256, 64, True, 0), (1, 8, 2, 256, 256, 32, True, 64),
               (2, 2, 2, 128, 128, 128, False, 0), (1, 4, 1, 384, 384, 64, True, 128),
               (1, 4, 4, 200, 200, 64, True, 0)]
FLASH_YI = [(1, 32, 4, s, s, 128, True, 0) for s in (77, 128, 1000, 2048)]
FLASH_OTHER = [(1, 8, 4, 300, 300, 256, True, 64), (2, 4, 2, 50, 50, 16, True, 32),
               (1, 4, 2, 100, 150, 64, False, 0)]
# recurrentgemma-2b's local attention: MQA, head_dim 256, window 2048 < S.
FLASH_RG = [(1, 10, 1, 3000, 3000, 256, True, 2048)]
# The tiled bf16 kernel's edges, in the model's layout: a prompt shorter
# than one tile at head_dim 128 and 256; a window that is not a multiple of
# the key tile; recurrentgemma's 10:1 MQA at S = 1,000 (yi-9b's group of 8
# at S = 1,000 is in FLASH_YI); Skv > Sq without the causal mask; and launches
# with enough tiles for two consumer warpgroups at the small head dims.
FLASH_EDGE = [(1, 4, 2, 50, 50, 128, True, 0), (1, 10, 1, 50, 50, 256, True, 2048),
              (1, 4, 1, 700, 700, 128, True, 100), (1, 10, 1, 700, 700, 256, True, 100),
              (1, 10, 1, 1000, 1000, 256, True, 2048), (1, 4, 2, 100, 300, 128, False, 0),
              (2, 16, 8, 640, 640, 64, True, 0), (2, 16, 8, 640, 640, 32, True, 128),
              (2, 16, 8, 640, 640, 16, True, 0)]
FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}
# RG-LRU checks (b, s, w): the reference sweep of tests/test_kernels.py, with
# h0; then the model's shapes, a prefill and a decode tick.
RGLRU_SWEEP = [(2, 64, 128), (1, 128, 200), (3, 32, 64)]
RGLRU_MODEL = [(1, 3000, 2560, False), (4, 1, 2560, True)]
# S around the chunk length L (0, 1, L - 1, L, L + 1, 3L + 5) at a ragged W,
# and the model's S at its W; B = 1 and 3, with and without h0.
RGLRU_EDGE_W, RGLRU_EDGE_MODEL = 200, (3000, 2560)
RGLRU_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}

# Serving.  The checks cut depth and run in float32 with TF32 off (greedy
# equality between batch 4 and batch 1 is fragile in bf16); the serve
# phases run at full depth in bf16.  Every request asks for SERVE_NEW tokens
# (CHECK_NEW in the checks), 16 requests over 4 slots, half of them
# submitted after 3 ticks.
YI, RG = "yi-9b", "recurrentgemma-2b"
CHECK_REQUESTS, CHECK_NEW = 8, 8
SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS = 16, 16, 4
YI_CHECK_LAYERS, YI_CHECK_PROMPT, YI_CHECK_MAX_SEQ = 4, (20, 601), 1024
YI_SERVE_PROMPT, YI_SERVE_MAX_SEQ = (64, 1025), 2048
# recurrentgemma-2b: one period (rec, rec, local) in the check; prompts of
# up to 3,500 tokens, past the local window of 2,048, in both phases.
RG_CHECK_LAYERS, RG_MAX_SEQ = 3, 4096
RG_CHECK_PROMPTS = ((6, (20, 2049)), (2, (2049, 3001)))
RG_SERVE_PROMPTS = ((12, (64, 1025)), (4, (2100, 3501)))


def emit(obj: dict) -> None:
    """Print ``obj`` as a JSON line; a phase's line gets the seconds since
    the run started."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def installed_version(dist: str) -> str | None:
    try:
        return importlib.metadata.version(dist)
    except importlib.metadata.PackageNotFoundError:
        return None


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def ptxas_report(source: Path, flags: tuple[str, ...] = ()) -> list[str]:
    """What ``ptxas -v`` says of the kernels of ``source``: registers, shared
    memory and spills, built with the flags of the library the run loads."""
    cubin = _build.BUILD_DIR / f"{source.stem}-ptxas.cubin"
    cubin.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", *flags, "-Xptxas", "-v", "-cubin",
         "-o", str(cubin), str(source)],
        check=True, capture_output=True, text=True)
    return [line.split("ptxas info    : ")[-1] for line in proc.stderr.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def event_ms(fn, reps: int) -> list[float]:
    """CUDA-event time of each of ``reps`` calls of ``fn``, in ms."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def check_kernel(h: int, w: int, max_iters: int):
    """Grid entry against plain version on one grid, then the line entry on
    every row against the grid's row sums (``check_line_entry``): exact
    equality."""
    x0, y0 = grid_coords(h, w, device="cuda")
    it_k, col_k = mandel_kernel.mandelbrot_cuda(x0, y0, max_iters)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    it_p, col_p = mandelbrot_reference(x0, y0, max_iters)
    end.record()
    end.synchronize()
    err = max(int((it_k - it_p).abs().max()), int((col_k - col_p).abs().max()))
    same = torch.equal(it_k, it_p) and torch.equal(col_k, col_p)
    emit({"phase": "kernel_vs_plain", "shape": [h, w], "max_iters": max_iters,
          "equal": same, "max_abs_err": err})
    if not same:
        raise SystemExit(f"kernel differs from plain version at {h}x{w}x{max_iters}")
    check_line_entry(it_k, col_k, max_iters)
    return x0, y0, it_k, col_k, err, start.elapsed_time(end)


def check_line_entry(iters, colour, max_iters: int) -> None:
    """The line entry, as the work function calls it, on every row of a
    ``grid_coords`` grid: each row's (white, total_iters) must equal the
    grid's row sums.  On the paper's image, its 3,200 lines."""
    h, w = iters.shape
    got = torch.stack([mandelbrot_line_stats(w, r, max_iters, device="cuda")
                       for r in range(h)])
    want = torch.stack((colour.sum(1, dtype=torch.int64),
                        iters.sum(1, dtype=torch.int64)), 1)
    off = (got != want).any(1).nonzero().flatten().tolist()
    emit({"phase": "line_entry_vs_grid", "shape": [h, w], "max_iters": max_iters,
          "lines": h, "lines_differing": len(off)})
    if off:
        raise SystemExit(f"line entry differs from the grid's row sums at "
                         f"{h}x{w}x{max_iters}, lines {off[:10]}")


def line_path_ms(launch_line, max_clock_hz: float) -> tuple[float, float, float]:
    """Device time of the paper's 3,200 lines, one ``launch_line(r)`` call
    each, in ms; with the host's enqueue time and its longest chunk.

    Each chunk of calls is enqueued behind a spin kernel, so its events time
    the device alone; the host clock times the enqueue.
    """
    device_ms = host_ms = chunk_host_max_ms = 0.0
    for c in range(0, LINES, LINE_CHUNK):
        torch.cuda._sleep(int(SPIN_S * max_clock_hz))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for r in range(c, min(c + LINE_CHUNK, LINES)):
            launch_line(r)
        chunk_ms = (time.perf_counter() - t0) * 1e3
        host_ms += chunk_ms
        chunk_host_max_ms = max(chunk_host_max_ms, chunk_ms)
        end.record()
        end.synchronize()
        device_ms += start.elapsed_time(end)
    return device_ms, host_ms, chunk_host_max_ms


def profile_work_items(calculate) -> None:
    """Device operations of ``PROFILED_ITEMS`` work items, by kind, from
    torch.profiler: kernels and memsets are launches, copies go to the host.

    The items run twice, a warm-up step and a recorded one: traced right
    after another profile, the first items' device events went missing
    (97 of 100 kernels, H100).
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for recorded in (False, True):
            for r in range(PROFILED_ITEMS):
                calculate(r)
            torch.cuda.synchronize()
            if not recorded:
                prof.step()
    by_kind = {"kernels": 0, "memsets": 0, "copies": 0}
    names = {}
    for evt in prof.key_averages():
        if (getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA
                or evt.key.startswith("ProfilerStep")):  # the step's own span
            continue
        kind = ("copies" if evt.key.startswith("Memcpy") else
                "memsets" if evt.key.startswith("Memset") else "kernels")
        by_kind[kind] += evt.count
        names[evt.key[:80]] = evt.count
    launches = by_kind["kernels"] + by_kind["memsets"]
    line_kernel = sum(n for k, n in names.items() if "mandelbrot_line_kernel" in k)
    emit({"phase": "work_item_profile", "items": PROFILED_ITEMS, **by_kind,
          "device_launches_per_item": launches / PROFILED_ITEMS,
          "line_kernel_launches": line_kernel, "names": names})
    if launches != 2 * PROFILED_ITEMS or line_kernel != PROFILED_ITEMS:
        raise SystemExit(f"work items launched {launches} device operations "
                         f"({line_kernel} line kernels) over {PROFILED_ITEMS} "
                         "items, expected two an item, one of them the line kernel")


def run_job(spec, launches_expected: int):
    """parse -> verify -> plan -> threads build -> run, counting launches."""
    report = verify_spec(spec)
    if not report.ok:
        raise SystemExit("spec failed verification:\n" + report.summary())
    builder = ClusterBuilder()
    plan = builder.deployment_plan(spec)
    app = builder.build_application(spec, backend="threads")
    t0 = time.perf_counter()
    result = app.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = mandel_kernel.LAUNCHES
    if launches != launches_expected:
        raise SystemExit(
            f"job launched the kernel {launches} times, expected "
            f"{launches_expected}")
    return result, wall_s, builder.timing, len(plan.nodes), launches


# What a node-loader's boot and first item cost, in one fresh interpreter
# with the nodes' environment and no other node booting beside it.
NODE_BOOT_PROBE = """
import json, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
import repro_torch.quickstart as qs
from repro_torch.kernels.mandelbrot import kernel
t2 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t3 = time.perf_counter()
qs.Calculate(qs.WIDTH, qs.MAX_ITERATIONS, "cuda")(0)
t4 = time.perf_counter()
qs.Calculate(qs.WIDTH, qs.MAX_ITERATIONS, "cuda")(1)
t5 = time.perf_counter()
print(json.dumps({"import_torch_ms": (t1 - t0) * 1e3,
                  "import_quickstart_ms": (t2 - t1) * 1e3,
                  "cuda_context_ms": (t3 - t2) * 1e3,
                  "first_item_ms": (t4 - t3) * 1e3,
                  "second_item_ms": (t5 - t4) * 1e3,
                  "launches": kernel.LAUNCHES}))
"""


def probe_node_boot() -> None:
    """Split a node's boot and first item into their parts."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", NODE_BOOT_PROBE],
                         env=_child_env(), check=True, capture_output=True,
                         text=True, timeout=120)
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    emit({"phase": "node_boot_probe", "process_wall_ms":
          (time.perf_counter() - t0) * 1e3, **probe})
    if probe["launches"] != 2:
        raise SystemExit(f"the probe's two items launched the line kernel "
                         f"{probe['launches']} times, expected 2")


class CountedCalculate(Calculate):
    """The paper's work function, its result also carrying the line
    kernel's launch count so far in the process that ran it.  A class of
    this script: cloudpickle ships it to the node-loaders by value, where
    the base class and the kernel's module resolve by reference."""

    def __call__(self, line_y: int) -> dict:
        out = Calculate.__call__(self, line_y)
        out["pid"] = os.getpid()
        out["launches"] = mandel_kernel.LAUNCHES
        return out


def counted_collector(acc, item):
    """The paper's collector, also keeping the highest launch count each
    node process reported: each item reads the count after its own launch,
    so the highest is the process's count at its last launch."""
    seen = acc.setdefault("launches", {})
    seen[item["pid"]] = max(seen.get(item["pid"], 0), item["launches"])
    return collector(acc, item)


def run_cluster_job(expected: dict, threads_wall_s: list[float]) -> None:
    """The paper's parsed spec over node-loader subprocesses on the card:
    the counts, the items per node, the line kernel's launches in each node
    process, the children's exits and the timing.

    The work function is the paper's, counting: each node process starts
    with a count of 0 and launches the line kernel only for its items, so
    its count must equal its items, and the counts must sum to the job's
    lines."""
    if installed_version("cloudpickle") is None:
        raise SystemExit("job_cluster ships its counting work function by "
                         "value, which needs cloudpickle")
    calc = make_calculate(WIDTH, MAX_ITERATIONS)  # builds the library here
    spec = parse_cgpp(
        SPEC % {"iters": MAX_ITERATIONS, "width": WIDTH, "lines": LINES},
        namespace={"CALCULATE": CountedCalculate(calc.width, calc.max_iters,
                                                 calc.device),
                   "COLLECTOR": counted_collector})
    builder = ClusterBuilder()
    app = builder.build_application(spec, backend="cluster",
                                    **backend_options("cluster"))
    t0 = time.perf_counter()
    result = app.run()
    wall_s = time.perf_counter() - t0
    by_pid = result.pop("launches")
    if result != expected:
        raise SystemExit(f"cluster job counts {result} != full-grid counts "
                         f"{expected}")
    nodes = {t.node_id: t.as_dict() for t in builder.timing.nodes
             if t.node_id != "host"}
    items = [n["items"] for n in nodes.values()]
    if len(nodes) != 2 or sum(items) != LINES or min(items) == 0:
        raise SystemExit(f"items per node {items} must be two shares of "
                         f"{LINES}, none empty")
    pids = {nid: app.host_loader.membership.nodes[nid].pid for nid in nodes}
    launches = {nid: by_pid.get(pid, 0) for nid, pid in pids.items()}
    if (sorted(by_pid) != sorted(pids.values())
            or any(launches[nid] != nodes[nid]["items"] for nid in nodes)
            or sum(launches.values()) != LINES):
        raise SystemExit(f"line kernel launches per node {launches} (by pid "
                         f"{by_pid}, node pids {pids}) must equal the items "
                         f"per node and sum to {LINES}")
    exits = {nid: h.returncode for nid, h in app.processes.items()}
    if app.orphaned() or any(code != 0 for code in exits.values()):
        raise SystemExit(f"node-loaders left running {app.orphaned()} or "
                         f"exited non-zero {exits}")
    host = next(t for t in builder.timing.nodes if t.node_id == "host")
    emit({"phase": "job_cluster", "backend": "cluster", "result": result,
          "launches": launches,
          "wall_s": wall_s, "threads_wall_s": threads_wall_s,
          "host_load_ms": host.load_ms, "host_run_ms": host.run_ms,
          "nodes": nodes, "exit_codes": exits, "wire": builder.timing.wire,
          "preload": backend_options("cluster")["preload"]})


# The warm pool's geometry is the paper's (2 nodes x 4 workers); its
# liveness is the cluster backend's default (a death shows after 5 s of
# silence); one heal; a node is killed once the heal job collected this many
# items.
POOL_HEALS = 1
KILL_AFTER_ITEMS = 100


def pool_job_launches(svc, handles, expected: dict, seen: dict[int, int],
                      label: str, skip: tuple[str, ...] = ()) -> dict:
    """The results of jobs that ran together on the pool: each job's counts
    must equal the full grid's and its items sum to the lines; each node's
    line-kernel launches over these jobs (its process's count now less the
    count before them, ``seen``) must equal its items in them.  ``skip``
    names a node whose process died mid-job: its last launches never
    reported back."""
    items: dict[str, int] = {}
    top: dict[int, int] = {}
    for h in handles:
        result = dict(h.result(timeout=600))
        for pid, count in result.pop("launches").items():
            top[pid] = max(top.get(pid, 0), count)
        if result != expected:
            raise SystemExit(f"{label}: pool job counts {result} != full-grid "
                             f"counts {expected}")
        stats = h.stats()
        per_node = {nid: d.get("items", 0) for nid, d in stats["nodes"].items()}
        if stats["items_collected"] != LINES or sum(per_node.values()) != LINES:
            raise SystemExit(f"{label}: {stats['items_collected']} items "
                             f"collected, per node {per_node}: every line once")
        for nid, n in per_node.items():
            items[nid] = items.get(nid, 0) + n
    pids = {nid: rec.pid for nid, rec in svc.host_loader.membership.nodes.items()
            if rec.pid}
    launches = {nid: top.get(pid, seen.get(pid, 0)) - seen.get(pid, 0)
                for nid, pid in pids.items() if nid not in skip}
    seen.update(top)
    bad = {nid: (launches[nid], items.get(nid, 0)) for nid in launches
           if launches[nid] != items.get(nid, 0)}
    if bad:
        raise SystemExit(f"{label}: line kernel launches != items per node "
                         f"(launches, items): {bad}")
    return {"items": items, "launches": launches}


def node_boot_ms(svc) -> dict[str, float]:
    """Each pool node's boot time as its heartbeats report it (0 until its
    preload is done)."""
    return {nid: (node.get("report") or {}).get("boot_ms", 0.0)
            for nid, node in svc.metrics_snapshot()["nodes"].items()}


def run_service_jobs(expected: dict, threads_wall_s: list[float]) -> None:
    """The paper's parsed spec as jobs of a warm pool of node-loader
    subprocesses on the card: boot once, three submissions of one spec
    object back to back, two at once, and one with a node killed mid-job
    that the pool heals by a relaunch.  Every check exits the run."""
    calc = make_calculate(WIDTH, MAX_ITERATIONS)  # builds the library here
    spec = parse_cgpp(
        SPEC % {"iters": MAX_ITERATIONS, "width": WIDTH, "lines": LINES},
        namespace={"CALCULATE": CountedCalculate(calc.width, calc.max_iters,
                                                 calc.device),
                   "COLLECTOR": counted_collector})
    threads_s = statistics.mean(threads_wall_s)
    svc = ClusterService(
        nodes=spec.nclusters, workers=spec.workers_per_node,
        launcher=LocalLauncher(**backend_options("service")),
        max_heals=POOL_HEALS)
    seen: dict[int, int] = {}  # node pid -> its line-kernel launches so far
    out: dict = {"preload": backend_options("service")["preload"],
                 "threads_wall_s": threads_wall_s}
    try:
        t0 = time.perf_counter()
        svc.start()
        out["pool_start_wall_s"] = time.perf_counter() - t0
        out["pool_boot_ms"] = svc.boot_ms

        submissions = []
        for k in range(3):
            t0 = time.perf_counter()
            h = svc.submit(spec, timeout=600)
            h.result(timeout=600)
            wall_s = time.perf_counter() - t0
            stats = h.stats()
            row = {"wall_s": wall_s, "ratio_to_threads": wall_s / threads_s,
                   "submit_to_first_result_ms": h.submit_to_first_result_ms,
                   "cluster_boot_ms": h.cluster_boot_ms,
                   "code_shipped": stats["code_shipped"],
                   "code_cached": stats["code_cached"],
                   **pool_job_launches(svc, [h], expected, seen,
                                       f"submission {k + 1}")}
            if k and (row["cluster_boot_ms"] != 0 or row["code_shipped"] != 0):
                raise SystemExit(f"warm submission {k + 1} paid boot "
                                 f"{row['cluster_boot_ms']} ms or shipped "
                                 f"{row['code_shipped']} stage functions")
            submissions.append(row)
        out["submissions"] = submissions
        # start() returns at the registration barrier, before the nodes'
        # preload ends; their heartbeats carry each one's boot once it has.
        out["node_boot_ms"] = node_boot_ms(svc)

        t0 = time.perf_counter()
        both = [svc.submit(spec, timeout=600) for _ in range(2)]
        out["concurrent"] = {
            **pool_job_launches(svc, both, expected, seen, "concurrent"),
            "wall_s": time.perf_counter() - t0}

        t0 = time.perf_counter()
        h = svc.submit(spec, timeout=600)
        while h.stats()["items_collected"] <= KILL_AFTER_ITEMS:
            if h.done():
                raise SystemExit("the heal job ended before its kill")
            time.sleep(0.002)
        killed_at_items = h.stats()["items_collected"]
        svc.kill_node("node1")
        t_kill = time.perf_counter()
        heal = pool_job_launches(svc, [h], expected, seen, "heal",
                                 skip=("node1",))
        heal_wall_s = time.perf_counter() - t0
        hl = svc.host_loader
        replacements = [nid for nid in hl.membership.nodes
                        if nid.startswith("node1r")]
        if hl.stats.heals != POOL_HEALS or len(replacements) != 1:
            raise SystemExit(f"heals {hl.stats.heals}, replacements "
                             f"{replacements}: the kill must be healed once")
        (replacement,) = replacements
        # Booted: its heartbeat reports a boot time once its preload (the
        # import of torch) is done.
        deadline = time.monotonic() + 300
        while not node_boot_ms(svc).get(replacement):
            if time.monotonic() > deadline:
                raise SystemExit(f"replacement {replacement} never booted: "
                                 f"{hl.membership.describe()}")
            time.sleep(0.05)
        out["heal"] = {
            **heal, "wall_s": heal_wall_s, "killed": "node1",
            "killed_at_items": killed_at_items,
            "replacement": replacement,
            "kill_to_replacement_booted_s": time.perf_counter() - t_kill,
            "deaths_detected": hl.stats.deaths_detected,
            "redispatched": hl.stats.redispatched,
            "duplicates_dropped": h.stats()["duplicates_dropped"]}
    finally:
        svc.close()
    out["node_timing"] = {t.node_id: t.as_dict() for t in svc.timing.nodes
                          if t.node_id != "host"}
    if replacement not in out["node_timing"]:
        raise SystemExit(f"the replacement {replacement} returned no timing")
    out["heal"]["replacement_boot_ms"] = \
        out["node_timing"][replacement]["boot_ms"]
    exits = {nid: h.returncode for nid, h in svc.handles.items()}
    out["exit_codes"] = exits
    if svc.orphaned() or any(code != 0 for nid, code in exits.items()
                             if nid != "node1"):
        raise SystemExit(f"node-loaders left running {svc.orphaned()} or "
                         f"survivors exited non-zero {exits}")
    emit({"phase": "job_service", **out})


def main() -> None:
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    max_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    # Full float32 products and convolutions in the float32 checks.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "card", "nvidia_smi": card, "kind": kind,
          "max_sm_clock_mhz": max_clock_hz / 1e6,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          # the process transport's optional codecs: without them the
          # work function ships by plain pickle and payloads by pickle
          **{name: installed_version(name) for name in ("cloudpickle", "msgpack")}})

    def timed_load(module):
        t = time.perf_counter()
        module.load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(7) as pool:
        builds = {name: pool.submit(timed_load, module) for name, module in (
            ("mandelbrot", mandel_kernel), ("rmsnorm", rms_kernel),
            ("flash_attention", flash_kernel), ("rglru", rglru_kernel))}
        ptxas = {f"{name}_ptxas": pool.submit(ptxas_report, module.SOURCE, flags)
                 for name, module, flags in (
                     ("mandelbrot", mandel_kernel, mandel_kernel.FLAGS),
                     ("rmsnorm", rms_kernel, ()), ("rglru", rglru_kernel, ()))}
        seconds = {name: f.result() for name, f in builds.items()}
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "per_kernel_s": seconds,
              **{key: f.result() for key, f in ptxas.items()}})

    chunk = mandel_kernel.chunk()
    k_edge = [(h, w, n) for h, w in K_EDGE_SHAPES
              for n in (0, 1, chunk - 1, chunk, chunk + 1, MAX_ITERATIONS)]
    emit({"phase": "mandelbrot_chunk", "trips_between_escape_branches": chunk})
    max_err = 0
    for h, w, n in CHECK_SHAPES + [c for c in k_edge if c not in CHECK_SHAPES]:
        max_err = max(max_err, check_kernel(h, w, n)[4])
    x0, y0, iters, colour, err, plain_ms = check_kernel(LINES, WIDTH, MAX_ITERATIONS)
    max_err = max(max_err, err)

    # Full-grid timing: one launch over the whole image.
    def one_grid():
        mandel_kernel.mandelbrot_cuda(x0, y0, MAX_ITERATIONS)

    event_ms(one_grid, 2)  # warm-up
    kernel_ms = statistics.median(event_ms(one_grid, 7))

    # The main path's shape, one line a launch, timed in turns: the line
    # entry as the work function calls it (zeroing its output included),
    # then the grid entry on each [1, W] row of the image, twice each.
    cuda = torch.device("cuda")

    def line_entry(r):
        mandelbrot_line_stats(WIDTH, r, MAX_ITERATIONS, device=cuda)

    def grid_entry(r):
        mandel_kernel.mandelbrot_cuda(x0[r:r + 1], y0[r:r + 1], MAX_ITERATIONS)

    line_entry(0)  # warm-up
    grid_entry(0)
    per_line = {"line_entry": [], "grid_entry": []}
    for name in ("line_entry", "grid_entry", "grid_entry", "line_entry"):
        per_line[name].append(line_path_ms(
            line_entry if name == "line_entry" else grid_entry, max_clock_hz))
    line_device_ms, line_host_ms, chunk_host_max_ms = per_line["grid_entry"][0]
    entry_device_ms = per_line["line_entry"][0][0]
    # A line waits on its slowest point's chain of trips.
    floor_ms = (int(iters.max(1).values.sum(dtype=torch.int64))
                * TRIP_LATENCY_CYCLES / max_clock_hz * 1e3)

    total_iters = int(iters.sum(dtype=torch.int64))
    white = int(colour.sum())
    points = LINES * WIDTH
    lane_rate = SMS * FP32_LANES * max_clock_hz  # FP32 instructions / s
    ops_ms = total_iters * INSTR_PER_ITER / lane_rate * 1e3
    bytes_ms = points * BYTES_PER_POINT / HBM_BYTES_PER_S * 1e3
    fixed_trip_ms = points * MAX_ITERATIONS * INSTR_PER_ITER / lane_rate * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    emit({"phase": "full_grid", "shape": [LINES, WIDTH],
          "max_iters": MAX_ITERATIONS, "full_grid_kernel_ms": kernel_ms,
          "per_line_device_ms": line_device_ms,
          "per_line_host_enqueue_ms": line_host_ms,
          # below the spin, the chunk waited in the queue: device time only
          "per_line_chunk_enqueue_max_ms": chunk_host_max_ms,
          "per_line_spin_ms": SPIN_S * 1e3,
          "line_entry_device_ms": entry_device_ms,
          # [device ms, host enqueue ms, longest chunk's enqueue ms] per
          # reading, in the order line, grid, grid, line
          "per_line_readings": per_line,
          "line_latency_floor_ms": floor_ms, "plain_ms": plain_ms,
          "total_iters": total_iters, "mean_iters": total_iters / points,
          "white_fraction": white / points, "bound_ms": bound_ms,
          "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
          "fixed_trip_bound_ms": fixed_trip_ms})

    # The main path: the paper's job, through the user's entry points.
    reset_launches()
    result, wall_s, timing, nodes, launches = run_job(mandelbrot_spec(), LINES)
    expected = {"points": points, "white": white, "black": points - white,
                "total_iters": total_iters}
    if result != expected:
        raise SystemExit(f"job counts {result} != full-grid counts {expected}")
    if not 0.70 < white / points < 0.90:
        raise SystemExit(f"white fraction {white / points} outside 0.70-0.90")
    emit({"phase": "main_path", "backend": "threads", "nodes": nodes,
          "result": result, "launches": launches, "wall_s": wall_s,
          "run_ms": timing.total_run_ms(), "timing": timing.summary()})

    # The same job over node-loader processes, in turns with the threads
    # job above: threads, cluster, cluster, threads.  The nodes' launches
    # are made in their own processes: each node's count comes back with
    # its results (``run_cluster_job``).
    threads_wall_s = [wall_s]
    for _ in range(2):
        run_cluster_job(expected, threads_wall_s)
    reset_launches()
    again, wall_s, _t, _n, _l = run_job(mandelbrot_spec(), LINES)
    if again != expected:
        raise SystemExit(f"threads job counts {again} != {expected}")
    threads_wall_s.append(wall_s)
    emit({"phase": "job_threads_again", "wall_s": wall_s,
          "threads_wall_s": threads_wall_s})
    run_service_jobs(expected, threads_wall_s)
    probe_node_boot()

    # The work function alone, serially in this thread: the job's work
    # without the threads runtime.
    calculate = make_calculate(WIDTH, MAX_ITERATIONS, torch.device("cuda"))
    t0 = time.perf_counter()
    items = [calculate(r) for r in range(LINES)]
    serial_s = time.perf_counter() - t0
    if sum(i["total_iters"] for i in items) != total_iters:
        raise SystemExit("serial work function disagrees with the full grid")
    emit({"phase": "work_function_serial", "items": len(items),
          "wall_s": serial_s})

    # The fluent two-stage pipeline: the image's first LINES // 4 lines.
    lines = LINES // 4
    reset_launches()
    fluent, f_wall_s, _t, _n, f_launches = run_job(fluent_spec(), lines)
    top = {"points": lines * WIDTH, "white": int(colour[:lines].sum()),
           "total_iters": int(iters[:lines].sum(dtype=torch.int64))}
    top["black"] = top["points"] - top["white"]
    if fluent != top:
        raise SystemExit(f"fluent counts {fluent} != grid rows {top}")
    emit({"phase": "fluent_pipeline", "result": fluent,
          "launches": f_launches, "wall_s": f_wall_s})

    # A kernel is judged at the shapes its main path gives it: "ms" is the
    # device time of the job's 3,200 line-entry launches, against the bound
    # of the same work.  The one full-grid launch and the latency floor of
    # one line at a time are in the full_grid phase; "plain_ms" is the plain
    # version over the same grid in one call.
    mandel_row = {
        "name": "mandelbrot_escape_time",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mandelbrot/csrc/mandelbrot.cu",
        "replaces": "src/repro/kernels/mandelbrot/kernel.py:31",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": entry_device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }

    errs = {"rmsnorm": check_rmsnorm(), "flash": check_flash(),
            "rglru": check_rglru()}
    serve_check(YI, "serve_check", YI_CHECK_LAYERS, YI_CHECK_MAX_SEQ,
                lambda rng, vocab: make_requests(
                    rng, CHECK_REQUESTS, YI_CHECK_PROMPT, CHECK_NEW, vocab))
    serves = {YI: serve_full(YI, "serve", YI_SERVE_MAX_SEQ,
                             lambda rng, vocab: make_requests(
                                 rng, SERVE_REQUESTS, YI_SERVE_PROMPT,
                                 SERVE_NEW, vocab), profile=False)}
    serve_check(RG, "serve_check_rg", RG_CHECK_LAYERS, RG_MAX_SEQ,
                lambda rng, vocab: requests_of_lengths(
                    rng, RG_CHECK_PROMPTS, CHECK_NEW, vocab))
    serves[RG] = serve_full(RG, "serve_rg", RG_MAX_SEQ,
                            lambda rng, vocab: requests_of_lengths(
                                rng, RG_SERVE_PROMPTS, SERVE_NEW, vocab),
                            profile=True)
    # After the timed phases: run before the serve phases, this profile left
    # their decode ticks 14-47 % slower on the host (H100, one call).
    profile_work_items(calculate)
    # serve_full checked each phase's flash launches: all wgmma, none f32.
    emit({"phase": "flash_variants", "serve_flash_launches": {
        variant: sum(serve["flash_variants"][variant] for serve in serves.values())
        for variant in ("wgmma", "f32")}})
    rows = kernel_rows(serves, errs)
    print(card, flush=True)
    emit({"kernels": [mandel_row, *rows]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# LM serving: kernel checks, serve checks, serve phases
# ---------------------------------------------------------------------------


def spun_device_ms(calls, max_clock_hz: float) -> tuple[float, bool]:
    """Device time of ``calls`` (thunks that launch work), in ms, and
    whether the host may have paced it.

    Each chunk of calls is enqueued behind a spin kernel, so its events
    time the device alone and not the host's enqueue rate, as long as the
    host finishes enqueueing the chunk before the spin ends.  32 calls of
    up to about 25 kernels each do, inside the queue of about a thousand
    pending launches.  A chunk whose enqueue outlasts the spin (a call of
    thousands of launches fills the queue and blocks the host) may have
    left the device waiting on the host; then its time is partly the
    host's, and the second value is True.
    """
    total, host_paced = 0.0, False
    for c in range(0, len(calls), CALL_CHUNK):
        torch.cuda._sleep(int(SPIN_S * max_clock_hz))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for call in calls[c:c + CALL_CHUNK]:
            call()
        host_paced |= time.perf_counter() - t0 > SPIN_S
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total, host_paced


def check_rmsnorm() -> float:
    """RMS-norm kernel against its plain version on the card."""
    gen = torch.Generator("cuda").manual_seed(0)
    worst = 0.0
    for xdt, sdt in RMS_DTYPES:
        for n, d in RMS_SHAPES:
            x = torch.randn((n, d), generator=gen, device="cuda").to(xdt)
            scale = (0.2 * torch.randn((d,), generator=gen, device="cuda")).to(sdt)
            got = rms_kernel.rms_norm_cuda(x, scale)
            want = rms_norm_reference(x, scale)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok = got.dtype == xdt and err <= RMS_TOL[xdt]
            emit({"phase": "rmsnorm_kernel_vs_plain", "shape": [n, d],
                  "x_dtype": str(xdt), "scale_dtype": str(sdt),
                  "max_abs_err": err, "tol": RMS_TOL[xdt], "ok": ok})
            if not ok:
                raise SystemExit(f"rmsnorm kernel differs at {n}x{d} {xdt}/{sdt}")
            worst = max(worst, err)
    check_rmsnorm_row_invariance(gen)
    count_rsqrt_rounding(gen)
    return worst


def check_rmsnorm_row_invariance(gen) -> None:
    """The same rows give the same bits in launches of 1, 4 and 1,000 rows,
    at both served widths: a batch-4 tick must normalise a request's row as
    its batch-1 prefill and offline decode do."""
    for d in RMS_SERVED_D:
        for xdt, sdt in RMS_DTYPES:
            x = torch.randn((max(RMS_INVARIANCE_ROWS), d), generator=gen,
                            device="cuda").to(xdt)
            scale = (0.2 * torch.randn((d,), generator=gen, device="cuda")).to(sdt)
            outs = [rms_kernel.rms_norm_cuda(x[:n].contiguous(), scale)
                    for n in RMS_INVARIANCE_ROWS]
            same = {f"{few}_in_{many}": torch.equal(outs[j][:few], outs[i])
                    for i, few in enumerate(RMS_INVARIANCE_ROWS)
                    for j, many in enumerate(RMS_INVARIANCE_ROWS) if many > few}
            ok = all(same.values())
            emit({"phase": "rmsnorm_row_invariance", "d": d, "x_dtype": str(xdt),
                  "scale_dtype": str(sdt), "rows": list(RMS_INVARIANCE_ROWS),
                  "plan": rms_kernel.launch_plan(d, xdt)._asdict(),
                  "bit_equal": same, "ok": ok})
            if not ok:
                raise SystemExit(f"rmsnorm rows change with the launch's row count "
                                 f"at D = {d} {xdt}/{sdt}: {same}")


def count_rsqrt_rounding(gen) -> None:
    """How often the plain version's torch.rsqrt differs on the card from a
    correctly rounded 1 / sqrt, and by how many ulp: why the kernel takes
    rsqrtf (see the note at the head of rmsnorm.cu)."""
    v = 0.01 + 4 * torch.rand(1 << 22, generator=gen, device="cuda")
    plain, exact = torch.rsqrt(v), 1.0 / torch.sqrt(v)
    ulps = (plain.view(torch.int32) - exact.view(torch.int32)).abs()
    emit({"phase": "rmsnorm_rsqrt", "values": v.numel(),
          "differing": int((ulps > 0).sum()), "max_ulp": int(ulps.max())})


def flash_inputs(b, h, kv, sq, skv, d, dtype, gen, model_layout: bool):
    """q [b, h, sq, d], k/v [b, kv, skv, d]; views of [B, S, H, D] tensors
    when ``model_layout`` (as the model passes them)."""
    def make(heads, s):
        if model_layout:
            t = torch.randn((b, s, heads, d), generator=gen, device="cuda")
            return t.to(dtype).transpose(1, 2)
        return torch.randn((b, heads, s, d), generator=gen, device="cuda").to(dtype)
    return make(h, sq), make(kv, skv), make(kv, skv)


def flash_plain(q, k, v, causal, window):
    rep = q.shape[1] // k.shape[1]
    return attention_reference(q, k.repeat_interleave(rep, dim=1),
                               v.repeat_interleave(rep, dim=1),
                               causal=causal, window=window)


def check_flash() -> float:
    """Flash-attention kernel against its plain version on the card: each
    case in float32 through the f32 variant and in bfloat16 through the
    wgmma variant."""
    gen = torch.Generator("cuda").manual_seed(1)
    worst = 0.0
    cases = ([(c, False) for c in FLASH_SWEEP] + [(c, True) for c in FLASH_YI]
             + [(c, False) for c in FLASH_OTHER] + [(c, True) for c in FLASH_RG]
             + [(c, c[6]) for c in FLASH_EDGE])
    before = dict(flash_kernel.LAUNCHES_BY_VARIANT)
    for dtype in (torch.float32, torch.bfloat16):
        for (b, h, kv, sq, skv, d, causal, window), layout in cases:
            q, k, v = flash_inputs(b, h, kv, sq, skv, d, dtype, gen, layout)
            got = flash_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                    window=window)
            want = flash_plain(q, k, v, causal, window)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok = (got.dtype == dtype and bool(torch.isfinite(got).all())
                  and err <= FLASH_TOL[dtype])
            emit({"phase": "flash_kernel_vs_plain",
                  "shape": [b, h, kv, sq, skv, d], "causal": causal,
                  "window": window, "model_layout": layout,
                  "dtype": str(dtype), "max_abs_err": err,
                  "tol": FLASH_TOL[dtype], "ok": ok})
            if not ok:
                raise SystemExit(
                    f"flash kernel differs at {(b, h, kv, sq, skv, d)} "
                    f"causal={causal} window={window} {dtype}")
            worst = max(worst, err)
    ran = {k: n - before[k] for k, n in flash_kernel.LAUNCHES_BY_VARIANT.items()}
    if ran != {"wgmma": len(cases), "f32": len(cases)}:
        raise SystemExit(f"flash checks ran {ran}, expected {len(cases)} of each variant")
    return worst


def model_gates(b: int, s: int, w: int, gen, seed: int = 0):
    """(a, bx) as recurrentgemma's gates make them from x ~ N(0, 1), with
    one layer's RG-LRU parameters from ``init_params``: |h| stays near |x|."""
    layer = {k: v[0] for k, v in init_params(
        rec_mod.rglru_param_specs(1, w), seed, "cuda").items()}
    x = torch.randn((b, s, w), generator=gen, device="cuda")
    return rec_mod._gates(layer, x)


def check_rglru() -> float:
    """RG-LRU kernel against its plain versions on the card: within
    ``RGLRU_TOL`` of the sequential scan and bit-equal to the chunked one at
    the plan's chunk length, on the reference sweep with h0, state chaining,
    S around the chunk length and the model's shapes; the decode tick's
    shape (one chunk) bit-equal to the sequential scan."""
    gen = torch.Generator("cuda").manual_seed(4)
    worst = 0.0

    def compare(label, got, want, chunked, dtype, extra, sequential=False):
        nonlocal worst
        torch.cuda.synchronize()
        errs = [float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
                for g, w in zip(got, want)]
        bit_chunked = all(torch.equal(g, c) for g, c in zip(got, chunked))
        bit_sequential = all(torch.equal(g, w) for g, w in zip(got, want))
        ok = (got[0].dtype == dtype and got[1].dtype == torch.float32
              and all(bool(torch.isfinite(g).all()) for g in got)
              and max(errs) <= RGLRU_TOL[dtype] and bit_chunked
              and (bit_sequential or not sequential))
        emit({"phase": "rglru_kernel_vs_plain", "case": label, **extra,
              "dtype": str(dtype), "max_abs_err_h": errs[0],
              "max_abs_err_h_last": errs[1], "tol": RGLRU_TOL[dtype],
              "bit_equal_chunked": bit_chunked,
              "bit_equal_sequential": bit_sequential, "ok": ok})
        if not ok:
            raise SystemExit(f"rglru kernel differs: {label} {extra} {dtype}")
        worst = max(worst, *errs)

    def check(label, a, x, h0, dtype, extra, sequential=False):
        plan = rglru_kernel.chunk_plan(a.shape[1], a.shape[2])
        compare(label, rglru_kernel.rglru_scan_cuda(a, x, h0),
                rglru_scan_reference(a, x, h0),
                rglru_scan_chunked(a, x, h0, plan.length), dtype,
                {**extra, "chunk_len": plan.length, "chunks": plan.chunks},
                sequential)

    def inputs(b, s, w, dtype):
        a = (0.5 + 0.499 * torch.rand((b, s, w), generator=gen,
                                      device="cuda")).to(dtype)
        x = torch.randn((b, s, w), generator=gen, device="cuda").to(dtype)
        return a, x, torch.randn((b, w), generator=gen, device="cuda").to(dtype)

    L = rglru_kernel.TILE  # the chunk length of every S up to 1,024
    edges = [(s, RGLRU_EDGE_W) for s in (0, 1, L - 1, L, L + 1, 3 * L + 5)]
    edges.append(RGLRU_EDGE_MODEL)
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, w in RGLRU_SWEEP:
            a, x, h0 = inputs(b, s, w, dtype)
            check("sweep", a, x, h0, dtype, {"shape": [b, s, w]})
        for s, w in edges:
            for b in (1, 3):
                a, x, h0 = inputs(b, s, w, dtype)
                for with_h0 in (False, True):
                    check("chunk_edge", a, x, h0 if with_h0 else None, dtype,
                          {"shape": [b, s, w], "h0": with_h0})
        # Two halves with the carried state equal the whole.
        a = (0.5 + 0.49 * torch.rand((1, 64, 128), generator=gen,
                                     device="cuda")).to(dtype)
        x = torch.randn((1, 64, 128), generator=gen, device="cuda").to(dtype)
        halves = (a[:, :32].contiguous(), x[:, :32].contiguous()), \
            (a[:, 32:].contiguous(), x[:, 32:].contiguous())
        h1, last1 = rglru_kernel.rglru_scan_cuda(*halves[0])
        h2, last2 = rglru_kernel.rglru_scan_cuda(*halves[1], last1)
        length = rglru_kernel.chunk_plan(32, 128).length
        c1, clast1 = rglru_scan_chunked(*halves[0], None, length)
        c2, clast2 = rglru_scan_chunked(*halves[1], clast1, length)
        compare("state_chaining", (torch.cat([h1, h2], dim=1), last2),
                rglru_scan_reference(a, x), (torch.cat([c1, c2], dim=1), clast2),
                dtype, {"shape": [1, 64, 128]})
    for b, s, w, with_h0 in RGLRU_MODEL:
        a, bx = model_gates(b, s, w, gen)
        h0 = torch.randn((b, w), generator=gen, device="cuda") if with_h0 else None
        # A decode tick (S = 1) is one chunk: the sequential scan itself.
        check("model", a, bx, h0, torch.float32, {"shape": [b, s, w], "h0": with_h0},
              sequential=s <= rglru_kernel.chunk_plan(s, w).length)
    return worst


def randomize_small_params(params, gen) -> None:
    """Nonzero RMS-norm scales, so that (1 + scale) is exercised, and
    nonzero RG-LRU gate biases."""
    leaves = [params["final_norm"]]
    for block in params["blocks"].values():
        leaves += [block["ln1"], block["ln2"]]
        if "rec" in block:
            leaves += [block["rec"]["rglru"]["b_a"], block["rec"]["rglru"]["b_x"]]
    for leaf in leaves:
        leaf.copy_(0.2 * torch.randn(leaf.shape, generator=gen, device="cuda"))


def make_requests(rng, n, prompt_range, max_new, vocab):
    return [Request(rid=rid,
                    prompt=list(map(int, rng.integers(
                        0, vocab, int(rng.integers(*prompt_range))))),
                    max_new_tokens=max_new)
            for rid in range(n)]


def requests_of_lengths(rng, groups, max_new, vocab):
    """Requests whose prompt lengths are drawn group by group, ``(count,
    (low, high))``, then shuffled, so that the long ones land in both
    halves of the schedule."""
    lens = rng.permutation(np.concatenate(
        [rng.integers(lo, hi, n) for n, (lo, hi) in groups]))
    return [Request(rid=rid, prompt=list(map(int, rng.integers(0, vocab, int(n)))),
                    max_new_tokens=max_new)
            for rid, n in enumerate(lens)]


def serve_check(arch: str, phase: str, layers: int, max_seq: int, make) -> None:
    """Engine completions equal offline greedy decode: ``arch`` at full
    width, cut to ``layers`` layers, float32."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              compute_dtype="float32")
    params = init_params(lm.lm_param_specs(cfg), 0, "cuda", torch.float32)
    randomize_small_params(params, torch.Generator("cuda").manual_seed(2))
    engine = ServingEngine(cfg, params, max_slots=SERVE_SLOTS, max_seq=max_seq)
    reqs = make(np.random.default_rng(0), cfg.vocab_size)
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    done = engine.shutdown()
    wall_s = time.perf_counter() - t0
    mismatched = []
    for c in done:
        prompt, gen = c.tokens[:c.prompt_len], c.tokens[c.prompt_len:]
        if gen != offline_greedy(cfg, params, prompt, len(gen), max_seq):
            mismatched.append(c.rid)
    ok = len(done) == len(reqs) and not mismatched
    lens = sorted(c.prompt_len for c in done)
    emit({"phase": phase, "arch": arch, "d_model": cfg.d_model,
          "num_layers": cfg.num_layers, "layer_kinds": cfg.layer_counts(),
          "depth_cut": f"{layers} of {get_config(arch).num_layers} layers",
          "compute_dtype": cfg.compute_dtype, "requests": len(done),
          "max_seq": max_seq, "prompt_lens": lens,
          "prompts_past_window": sum(n > cfg.window_size > 0 for n in lens),
          "mismatched_rids": mismatched, "wall_s": wall_s, "ok": ok})
    if not ok:
        raise SystemExit(f"{arch}: engine != offline greedy decode for {mismatched}")
    del engine, params
    torch.cuda.empty_cache()


KERNELS = {"mandelbrot": mandel_kernel, "rmsnorm": rms_kernel,
           "flash": flash_kernel, "rglru": rglru_kernel}


def reset_launches() -> None:
    for module in KERNELS.values():
        module.LAUNCHES = 0
    flash_kernel.LAUNCHES_BY_VARIANT = dict.fromkeys(flash_kernel.LAUNCHES_BY_VARIANT, 0)


def expected_launches(cfg, prefills: int, ticks: int) -> dict[str, int]:
    """Per prefill pass and per tick: ln1 and ln2 in every block plus
    final_norm; one flash launch per attention layer per prefill; one
    RG-LRU launch per rec layer per prefill and per tick."""
    counts = cfg.layer_counts()
    rec = counts.get("rec", 0)
    return {"mandelbrot": 0,
            "rmsnorm": (2 * cfg.num_layers + 1) * (prefills + ticks),
            "flash": (cfg.num_layers - rec) * prefills,
            "rglru": rec * (prefills + ticks)}


def serve_full(arch: str, phase: str, max_seq: int, make,
               profile: bool) -> dict:
    """``arch`` at full width and depth in bf16, through ServingEngine;
    with ``profile``, a profiled repeat follows."""
    cfg = get_config(arch)
    specs = lm.lm_param_specs(cfg)
    t0 = time.perf_counter()
    params = init_params(specs, 0, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # Warm-up (cuBLAS handles and bf16 algorithms): one short request.
    warm = ServingEngine(cfg, params, max_slots=SERVE_SLOTS, max_seq=max_seq)
    warm.submit(Request(rid=-1, prompt=list(range(1, 65)), max_new_tokens=2))
    warm.shutdown()
    del warm
    engine = ServingEngine(cfg, params, max_slots=SERVE_SLOTS, max_seq=max_seq)

    reqs = make(np.random.default_rng(0), cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ticks, step_s = 0, 0.0

    def tick():
        nonlocal ticks, step_s
        t = time.perf_counter()
        active = engine.step()
        step_s += time.perf_counter() - t
        ticks += active > 0

    t0 = time.perf_counter()
    half = len(reqs) // 2
    for r in reqs[:half]:
        engine.submit(r)
    for _ in range(3):
        tick()
    for r in reqs[half:]:
        engine.submit(r)
    while engine.queue or (engine.slot_rid >= 0).any():
        tick()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: module.LAUNCHES for name, module in KERNELS.items()}
    flash_variants = dict(flash_kernel.LAUNCHES_BY_VARIANT)
    done = engine.shutdown()

    prefills = len(done)
    prompt_lens = [c.prompt_len for c in sorted(done, key=lambda c: c.rid)]
    gen = [t for c in done for t in c.tokens[c.prompt_len:]]
    expected = expected_launches(cfg, prefills, ticks)
    lat = sorted(c.latency_s for c in done)
    decode_ms = engine.timing.node("host").run_ms
    summary = {
        "phase": phase, "arch": arch, "num_layers": cfg.num_layers,
        "layer_kinds": cfg.layer_counts(),
        "d_model": cfg.d_model, "params": count_params(specs),
        "weights_dtype": "bfloat16", "init_params_s": init_s,
        "requests": prefills, "slots": SERVE_SLOTS, "max_seq": max_seq,
        "prompt_lens": prompt_lens,
        "prompts_past_window": sum(n > cfg.window_size > 0 for n in prompt_lens),
        "generated_tokens": len(gen),
        "wall_s": wall_s, "tokens_per_s": len(gen) / wall_s,
        "latency_p50_s": lat[len(lat) // 2],
        "latency_p99_s": lat[math.ceil(0.99 * len(lat)) - 1],
        "ticks": ticks, "decode_ms_per_tick": decode_ms / ticks,
        "prefill_ms_per_request": (step_s * 1e3 - decode_ms) / prefills,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "expected_launches": expected,
        "flash_launches_by_variant": flash_variants,
        "timing": engine.timing.summary(),
    }
    emit(summary)
    print(engine.timing.report(), flush=True)
    if len(done) != len(reqs) or len(gen) != len(reqs) * SERVE_NEW:
        raise SystemExit(f"{arch}: served {len(done)} requests, {len(gen)} tokens")
    if not all(0 <= t < cfg.vocab_size for t in gen):
        raise SystemExit(f"{arch}: a generated token lies outside [0, vocab)")
    if launches != expected:
        raise SystemExit(f"{arch}: kernel launches {launches} != expected {expected}")
    if flash_variants != {"wgmma": expected["flash"], "f32": 0}:
        raise SystemExit(f"{arch}: bf16 flash launches by variant {flash_variants}, "
                         f"expected all {expected['flash']} through wgmma")
    del engine
    if profile:
        profile_serve(cfg, params, reqs, wall_s, max_seq, phase + "_profile")
    del params
    torch.cuda.empty_cache()
    return {"cfg": cfg, "prompt_lens": prompt_lens, "ticks": ticks,
            "launches": launches, "flash_variants": flash_variants}


def kernel_events(prof) -> tuple[dict[str, float], int]:
    """Device µs by kernel name, and the number of kernels, of a profile."""
    kernel_us: dict[str, float] = {}
    count = 0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue  # a CPU op's device time is its kernels', counted here
        us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        kernel_us[evt.key] = kernel_us.get(evt.key, 0.0) + us
        count += evt.count
    return kernel_us, count


def profile_serve(cfg, params, reqs, serve_wall_s: float, max_seq: int,
                  phase: str) -> None:
    """Where the serve phase's time goes, from torch.profiler's kernel events.

    The same requests again give each kernel's device time; one decode tick
    and one prefill (at the prompts' mean length), each profiled alone,
    give their device time and kernel count.  The serve phase's own
    numbers come from its unprofiled run.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    engine = ServingEngine(cfg, params, max_slots=SERVE_SLOTS, max_seq=max_seq)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            engine.submit(r)
        engine.shutdown()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernel_us, kernels = kernel_events(prof)
    total_ms = sum(kernel_us.values()) / 1e3

    def share(word):
        return sum(us for k, us in kernel_us.items() if word in k) / 1e3

    mean_prompt = round(statistics.mean(len(r.prompt) for r in reqs))
    cache = lm.init_cache(cfg, SERVE_SLOTS, max_seq, device="cuda")
    tokens = torch.ones((SERVE_SLOTS, 1), dtype=torch.int64, device="cuda")
    lens = torch.full((SERVE_SLOTS,), mean_prompt, device="cuda")
    prompt = torch.ones((1, mean_prompt), dtype=torch.int64, device="cuda")
    alone = {}
    for name, fn in (
        ("decode_tick", lambda: lm.decode_step(cfg, params, cache, tokens, lens)),
        ("prefill", lambda: lm.prefill(cfg, params, prompt, max_seq)),
    ):
        fn()  # warm-up
        torch.cuda.synchronize()
        with profile(activities=activities) as one:
            fn()
            torch.cuda.synchronize()
        us, n = kernel_events(one)
        alone[f"{name}_device_ms"] = sum(us.values()) / 1e3
        alone[f"{name}_kernels"] = n
    emit({"phase": phase, "arch": cfg.name, "profiled_wall_s": wall_s,
          "kernel_device_ms": total_ms, "kernels": kernels,
          "device_busy_share_profiled": total_ms / 1e3 / wall_s,
          "device_busy_share_of_serve_wall": total_ms / 1e3 / serve_wall_s,
          "rmsnorm_kernel_ms": share("rmsnorm_kernel"),
          "flash_kernel_ms": share("flash_kernel"),
          "rglru_kernel_ms": share("rglru_kernel"),
          "top_kernels": [[k[:80], us / 1e3] for k, us in sorted(
              kernel_us.items(), key=lambda kv: -kv[1])[:10]],
          "prefill_tokens": mean_prompt, **alone})


def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal, optionally windowed, prompt attends."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def rmsnorm_work(serve, gen):
    """The serve phase's RMS-norm launches: [S, D] per prefill pass, [slots,
    D] per tick, bf16 rows and scale.  Its classes: the prefill's launches
    and the ticks'; its floor: as many launches at [1, 8]."""
    cfg = serve["cfg"]
    D, per_pass, bf16 = cfg.d_model, 2 * cfg.num_layers + 1, torch.bfloat16
    by_class = {"prefill": [s for s in serve["prompt_lens"] for _ in range(per_pass)],
                "tick": [SERVE_SLOTS] * (per_pass * serve["ticks"])}
    rows = by_class["prefill"] + by_class["tick"]
    scale = (0.2 * torch.randn((D,), generator=gen, device="cuda")).to(bf16)
    xs = {n: torch.randn((n, D), generator=gen, device="cuda").to(bf16)
          for n in set(rows)}
    weight = (1.0 + scale.float()).to(bf16)

    def kernel(n):
        return lambda: rms_kernel.rms_norm_cuda(xs[n], scale)

    def bytes_ms(ns):
        return sum(2 * n * D * 2 + D * 2 for n in ns) / HBM_BYTES_PER_S * 1e3

    calls = {
        "ms": [kernel(n) for n in rows],
        "plain_ms": [lambda n=n: rms_norm_reference(xs[n], scale) for n in rows],
        "library_ms": [lambda n=n: F.rms_norm(xs[n], (D,), weight, cfg.norm_eps)
                       for n in rows],
    }
    least_x = torch.randn((1, 8), generator=gen, device="cuda").to(bf16)
    least_scale = torch.zeros((8,), device="cuda", dtype=bf16)
    split = {"classes": {c: ([kernel(n) for n in ns], bytes_ms(ns))
                         for c, ns in by_class.items()},
             "floor": [lambda: rms_kernel.rms_norm_cuda(least_x, least_scale)]
             * len(rows)}
    return calls, 0.0, bytes_ms(rows), split


def flash_work(serve, gen):
    """The serve phase's flash launches: one [1, H, S, hd] causal launch per
    attention layer per prefill (windowed for ``local``), read in place from
    [1, S, H, hd]."""
    cfg = serve["cfg"]
    H, KV, hd, bf16 = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, torch.bfloat16
    launches = []
    for kind, n in cfg.layer_counts().items():
        if kind != "rec":
            window = cfg.window_size if kind == "local" else 0
            launches += [(s, window) for s in serve["prompt_lens"] for _ in range(n)]
    qkv = {s: flash_inputs(1, H, KV, s, s, hd, bf16, gen, True)
           for s in {s for s, _ in launches}}
    # The library call takes a band mask where the window cuts the prompt.
    masks = {(s, w): torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
             .triu(-(w - 1)) for s, w in set(launches) if 0 < w < s}

    def library(s, w):
        if (s, w) in masks:
            return F.scaled_dot_product_attention(
                *qkv[s], attn_mask=masks[(s, w)], enable_gqa=True)
        return F.scaled_dot_product_attention(*qkv[s], is_causal=True,
                                              enable_gqa=True)

    calls = {
        "ms": [lambda s=s, w=w: flash_kernel.flash_attention_cuda(
            *qkv[s], causal=True, window=w) for s, w in launches],
        "plain_ms": [lambda s=s, w=w: flash_plain(*qkv[s], True, w)
                     for s, w in launches],
        "library_ms": [lambda s=s, w=w: library(s, w) for s, w in launches],
    }
    flops = sum(4 * H * hd * visible_pairs(s, w) for s, w in launches)
    nbytes = sum(2 * s * (2 * H + 2 * KV) * hd for s, _ in launches)
    return (calls, flops / BF16_FLOPS_PER_S * 1e3,
            nbytes / HBM_BYTES_PER_S * 1e3, None)


def rglru_work(serve, gen):
    """The serve phase's RG-LRU launches: a and bx [1, S, W] in f32 per rec
    layer per prefill; [slots, 1, W] with the f32 state h0 per rec layer per
    tick.  The plain version launches three kernels a time step, so its
    prefill calls fill the launch queue and its replay is paced by the host
    (``spun_device_ms``).  Its classes: the prefills' launches and the
    ticks'; its floor: as many launches at [1, 1, 1]."""
    cfg = serve["cfg"]
    W, rec = cfg.rnn_width or cfg.d_model, cfg.layer_counts().get("rec", 0)
    lens = serve["prompt_lens"]
    a_p, b_p = model_gates(1, max(lens), W, gen, seed=1)
    a_t, b_t = model_gates(SERVE_SLOTS, 1, W, gen, seed=2)
    h0 = torch.randn((SERVE_SLOTS, W), generator=gen, device="cuda")
    prefill = [(a_p[:, :s], b_p[:, :s], None) for s in lens]
    tick = [(a_t, b_t, h0)] * serve["ticks"]
    one_layer = prefill + tick

    def kernel(args):
        return lambda: rglru_kernel.rglru_scan_cuda(*args)

    def bytes_ms(steps, rows_with_h0, rows):
        # a, b and h f32 at every step; h0 read and h_last written per row
        return (12 * steps * W + 4 * W * (rows + rows_with_h0)) * rec \
            / HBM_BYTES_PER_S * 1e3

    calls = {
        "ms": [kernel(c) for c in one_layer * rec],
        "plain_ms": [lambda c=c: rglru_scan_reference(*c)
                     for c in one_layer * rec],
        "library_ms": None,  # no PyTorch call computes a linear recurrence
    }
    ticks = SERVE_SLOTS * serve["ticks"]
    elems = (sum(lens) + ticks) * W * rec
    least = torch.rand((1, 1, 1), generator=gen, device="cuda")
    split = {"classes": {
        "prefill": ([kernel(c) for c in prefill * rec],
                    bytes_ms(sum(lens), 0, len(lens))),
        "tick": ([kernel(c) for c in tick * rec], bytes_ms(ticks, ticks, ticks))},
        "floor": [lambda: rglru_kernel.rglru_scan_cuda(least, least)]
        * len(calls["ms"])}
    return (calls, 2 * elems / FP32_FLOPS_PER_S * 1e3,
            bytes_ms(sum(lens) + ticks, ticks, len(lens) + ticks), split)


def kernel_rows(serves: dict, errs: dict) -> list[dict]:
    """Time the serve phases' kernel work again, launch for launch, beside
    the plain version and a library call at the same shapes.  A kernel's
    row sums over the serving paths that launch it; ``host_paced`` lists
    the times whose replay the host may have paced (``spun_device_ms``).
    RMS norm and RG-LRU also time their prefill and tick launches apart
    (``prefill``, ``tick``: launches, ms and the bytes bound of each) and
    the same number of launches at the kernel's least shape
    (``launch_floor_ms``)."""
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    gen = torch.Generator("cuda").manual_seed(3)
    out = []
    for name, key, src, replaces, work in (
        ("rmsnorm", "rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm/kernel.py:21", rmsnorm_work),
        ("flash_attention_forward", "flash",
         "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:32", flash_work),
        ("rglru_scan", "rglru", "src/repro_torch/kernels/rglru/csrc/rglru.cu",
         "src/repro/kernels/rglru/kernel.py:32", rglru_work),
    ):
        total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "ops_ms": 0.0,
                 "bytes_ms": 0.0, "launches": 0}
        classes: dict[str, dict] = {}
        floor_ms = 0.0
        host_paced = set()
        for arch, serve in serves.items():
            if not serve["launches"][key]:
                continue
            calls, ops_ms, bytes_ms, split = work(serve, gen)
            times, paced = {}, []
            for k, fns in calls.items():
                if fns is None:
                    times[k] = None
                    continue
                # Warm-up: every call once, so every shape has been seen
                # (cuDNN's attention, which SDPA may pick, builds a plan on
                # a shape's first call).
                for fn in fns:
                    fn()
                torch.cuda.synchronize()
                times[k], by_host = spun_device_ms(fns, clock_hz)
                if by_host:
                    paced.append(k)
            extra = {}
            if key == "flash":  # bf16 tensor-core work: its rate and SDPA's
                extra = {"tflops": ops_ms * BF16_FLOPS_PER_S / times["ms"] / 1e12,
                         "library_tflops":
                             ops_ms * BF16_FLOPS_PER_S / times["library_ms"] / 1e12,
                         "ms_over_library": times["ms"] / times["library_ms"],
                         "share_of_bound": ops_ms / times["ms"]}
            if split:  # the classes and the floor, each replayed on its own
                for cls, (fns, cls_bytes_ms) in split["classes"].items():
                    ms, by_host = spun_device_ms(fns, clock_hz)
                    if by_host:
                        paced.append(f"{cls}.ms")
                    extra[cls] = {"launches": len(fns), "ms": ms,
                                  "bytes_bound_ms": cls_bytes_ms}
                    summed = classes.setdefault(
                        cls, {"launches": 0, "ms": 0.0, "bytes_bound_ms": 0.0})
                    for k in summed:
                        summed[k] += extra[cls][k]
                split["floor"][0]()  # warm-up
                ms, by_host = spun_device_ms(split["floor"], clock_hz)
                if by_host:
                    paced.append("launch_floor_ms")
                extra["launch_floor_ms"] = ms
                floor_ms += ms
            emit({"phase": "kernel_time", "kernel": name, "arch": arch,
                  "launches": len(calls["ms"]), **times, "host_paced": paced,
                  "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms, **extra})
            if len(calls["ms"]) != serve["launches"][key]:
                raise SystemExit(f"{name}: replayed {len(calls['ms'])} launches, "
                                 f"the serve phase made {serve['launches'][key]}")
            for k in ("ms", "plain_ms", "library_ms"):
                total[k] = None if times[k] is None or total[k] is None \
                    else total[k] + times[k]
            total["ops_ms"] += ops_ms
            total["bytes_ms"] += bytes_ms
            total["launches"] += serve["launches"][key]
            host_paced.update(paced)
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": total["launches"], "max_abs_err": errs[key],
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": max(total["ops_ms"], total["bytes_ms"]),
            "bound_by": "operations" if total["ops_ms"] >= total["bytes_ms"]
            else "bytes",
            "library_ms": total["library_ms"],
            "host_paced": sorted(host_paced),
        }
        if key == "flash":
            row["tflops"] = total["ops_ms"] * BF16_FLOPS_PER_S / total["ms"] / 1e12
            row["ms_over_library"] = total["ms"] / total["library_ms"]
        if classes:
            row.update(classes)
            row["launch_floor_ms"] = floor_ms
        out.append(row)
    return out


if __name__ == "__main__":
    main()
