"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA escape-time kernel from ``src/repro_torch``, holds it
against its plain PyTorch version on the card (exact equality), then drives
the port's main path: the paper's Mandelbrot job (3,200 lines x 5,600
points, escape value 1,000, 2 clusters x 4 cores) parsed from ``.cgpp``,
verified, planned and run on the threads backend, every line through the
kernel.  Each phase prints one JSON line; any failure exits non-zero.  The
line before the last lists every kernel with its launches on the main path,
its device time at the main path's shapes and its bound; the last line is
the run's verdict.

Without a CUDA device, or without the repository around it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script measures the card only")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core.builder import ClusterBuilder  # noqa: E402
from repro_torch.core.verify import verify_spec  # noqa: E402
from repro_torch.kernels.mandelbrot import kernel as mandel_kernel  # noqa: E402
from repro_torch.kernels.mandelbrot.ref import (  # noqa: E402
    grid_coords,
    mandelbrot_reference,
)
from repro_torch.quickstart import (  # noqa: E402
    LINES,
    MAX_ITERATIONS,
    WIDTH,
    fluent_spec,
    make_calculate,
    mandelbrot_spec,
)

# H100 SXM: 132 SMs of 128 FP32 lanes; HBM3 at 3.35 TB/s (NVIDIA data sheet).
SMS = 132
FP32_LANES = 128
HBM_BYTES_PER_S = 3.35e12
# FP32 instructions per live iteration: two squares, the escape test's add
# and compare, the two fmas, the add of x0 (csrc/mandelbrot.cu).
INSTR_PER_ITER = 7
BYTES_PER_POINT = 16  # two f32 coordinates in, two i32 results out

# Per-line timing: launches per chunk (well inside the stream's queue of
# pending launches) and the spin that holds the stream while they enqueue.
LINE_CHUNK = 200
SPIN_S = 0.05

CHECK_SHAPES = [(9, 77, 30), (32, 300, 100), (64, 700, 1000), (1, WIDTH, 1000)]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


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
    """Kernel against plain version on one grid: exact equality."""
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
    return x0, y0, it_k, col_k, err, start.elapsed_time(end)


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


def main() -> None:
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    max_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    emit({"phase": "card", "nvidia_smi": card, "kind": kind,
          "max_sm_clock_mhz": max_clock_hz / 1e6,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    mandel_kernel.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    max_err = 0
    for h, w, n in CHECK_SHAPES:
        max_err = max(max_err, check_kernel(h, w, n)[4])
    x0, y0, iters, colour, err, plain_ms = check_kernel(LINES, WIDTH, MAX_ITERATIONS)
    max_err = max(max_err, err)

    # Full-grid timing: one launch over the whole image.
    def one_grid():
        mandel_kernel.mandelbrot_cuda(x0, y0, MAX_ITERATIONS)

    event_ms(one_grid, 2)  # warm-up
    kernel_ms = statistics.median(event_ms(one_grid, 7))

    # The main path's shape: one [1, W] launch per line.  Each chunk of
    # launches is enqueued behind a spin kernel, so its events time the
    # device alone; the host clock times the enqueue.
    rows = [(x0[r:r + 1], y0[r:r + 1]) for r in range(LINES)]
    line_device_ms = line_host_ms = chunk_host_max_ms = 0.0
    for c in range(0, LINES, LINE_CHUNK):
        torch.cuda._sleep(int(SPIN_S * max_clock_hz))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for xr, yr in rows[c:c + LINE_CHUNK]:
            mandel_kernel.mandelbrot_cuda(xr, yr, MAX_ITERATIONS)
        chunk_ms = (time.perf_counter() - t0) * 1e3
        line_host_ms += chunk_ms
        chunk_host_max_ms = max(chunk_host_max_ms, chunk_ms)
        end.record()
        end.synchronize()
        line_device_ms += start.elapsed_time(end)

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
          "per_line_spin_ms": SPIN_S * 1e3, "plain_ms": plain_ms,
          "total_iters": total_iters, "mean_iters": total_iters / points,
          "white_fraction": white / points, "bound_ms": bound_ms,
          "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
          "fixed_trip_bound_ms": fixed_trip_ms})

    # The main path: the paper's job, through the user's entry points.
    mandel_kernel.LAUNCHES = 0
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
    mandel_kernel.LAUNCHES = 0
    fluent, f_wall_s, _t, _n, f_launches = run_job(fluent_spec(), lines)
    top = {"points": lines * WIDTH, "white": int(colour[:lines].sum()),
           "total_iters": int(iters[:lines].sum(dtype=torch.int64))}
    top["black"] = top["points"] - top["white"]
    if fluent != top:
        raise SystemExit(f"fluent counts {fluent} != grid rows {top}")
    emit({"phase": "fluent_pipeline", "result": fluent,
          "launches": f_launches, "wall_s": f_wall_s})

    # A kernel is judged at the shapes its main path gives it: "ms" is the
    # device time of the job's 3,200 [1, W] launches, against the bound of
    # the same work.  The one full-grid launch is in the full_grid phase;
    # "plain_ms" is the plain version over the same grid in one call.
    emit({"kernels": [{
        "name": "mandelbrot_escape_time",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mandelbrot/csrc/mandelbrot.cu",
        "replaces": "src/repro/kernels/mandelbrot/kernel.py:31",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": line_device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
