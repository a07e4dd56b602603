"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch`` (one ``nvcc`` per
source, all at once) and drives the port's two paths on the card:

1. The paper's Mandelbrot job (3,200 lines x 5,600 points, escape value
   1,000, 2 clusters x 4 cores) parsed from ``.cgpp``, verified, planned and
   run on the threads backend, every line through the escape-time kernel,
   which is first held against its plain version (exact equality).
2. LM serving: the fused RMS-norm and flash-attention kernels are held
   against their plain versions; then ``ServingEngine`` serves yi-9b at
   full width, first cut to 4 layers in float32 (every completion must
   equal offline greedy decode), then at full depth (48 layers, bf16
   weights from ``init_params`` on the card), where the kernels' launches
   are counted.

Each phase prints one JSON line; any failure exits non-zero.  The line
before the last lists every kernel with its launches on its path, its
device time at that path's shapes, its bound, its plain version's time and
a library call's; the last line is the run's verdict.

Without a CUDA device, or without the repository around it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
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

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.builder import ClusterBuilder  # noqa: E402
from repro_torch.core.verify import verify_spec  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.kernels.mandelbrot import kernel as mandel_kernel  # noqa: E402
from repro_torch.kernels.mandelbrot.ref import (  # noqa: E402
    grid_coords,
    mandelbrot_reference,
)
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rms_norm_reference  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import count_params, init_params  # noqa: E402
from repro_torch.quickstart import (  # noqa: E402
    LINES,
    MAX_ITERATIONS,
    WIDTH,
    fluent_spec,
    make_calculate,
    mandelbrot_spec,
)
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serve_pipeline import offline_greedy  # noqa: E402

# H100 SXM: 132 SMs of 128 FP32 lanes; HBM3 at 3.35 TB/s; dense bf16 tensor
# cores at 989 TFLOP/s (NVIDIA data sheet).
SMS = 132
FP32_LANES = 128
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# FP32 instructions per live iteration: two squares, the escape test's add
# and compare, the two fmas, the add of x0 (csrc/mandelbrot.cu).
INSTR_PER_ITER = 7
BYTES_PER_POINT = 16  # two f32 coordinates in, two i32 results out

# Per-line timing: launches per chunk (well inside the stream's queue of
# pending launches) and the spin that holds the stream while they enqueue.
LINE_CHUNK = 200
SPIN_S = 0.05
CALL_CHUNK = 32  # calls per chunk when timing the serving kernels

CHECK_SHAPES = [(9, 77, 30), (32, 300, 100), (64, 700, 1000), (1, WIDTH, 1000)]

# RMS norm checks: [N, D], and the (x, scale) dtypes the model passes it.
RMS_SHAPES = [(9, 77), (128, 4096), (1000, 4096), (4, 4096)]
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
FLASH_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}

# Serving: yi-9b at full width.  serve_check cuts depth to 4 layers and runs
# in float32 (greedy equality between batch 4 and batch 1 is fragile in
# bf16); serve runs all 48 layers in bf16.
SERVE_ARCH = "yi-9b"
CHECK_LAYERS = 4
CHECK_REQUESTS, CHECK_PROMPT, CHECK_NEW, CHECK_MAX_SEQ = 8, (20, 601), 8, 1024
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 16, (64, 1025), 16
SERVE_SLOTS, SERVE_MAX_SEQ = 4, 2048


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

    def timed_load(module):
        t = time.perf_counter()
        module.load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = {name: pool.submit(timed_load, module) for name, module in (
            ("mandelbrot", mandel_kernel), ("rmsnorm", rms_kernel),
            ("flash_attention", flash_kernel))}
        seconds = {name: f.result() for name, f in builds.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": seconds})

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
    # device time of the job's 3,200 [1, W] launches, against the bound of
    # the same work.  The one full-grid launch is in the full_grid phase;
    # "plain_ms" is the plain version over the same grid in one call.
    mandel_row = {
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
    }

    rms_err = check_rmsnorm()
    flash_err = check_flash()
    serve_check()
    serve = serve_full()
    rows = kernel_rows(serve, rms_err, flash_err)
    print(card, flush=True)
    emit({"kernels": [mandel_row, *rows]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# LM serving: kernel checks, serve_check, serve
# ---------------------------------------------------------------------------


def spun_device_ms(calls, max_clock_hz: float) -> float:
    """Device time of ``calls`` (thunks that launch work), in ms.

    Each chunk of calls is enqueued behind a spin kernel, so its events
    time the device alone and not the host's enqueue rate.  A chunk must
    stay inside the queue of about a thousand pending launches, or the host
    blocks and its enqueue rate shows in the time: 32 calls of a plain
    version of up to about 25 kernels each do.
    """
    total = 0.0
    for c in range(0, len(calls), CALL_CHUNK):
        torch.cuda._sleep(int(SPIN_S * max_clock_hz))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for call in calls[c:c + CALL_CHUNK]:
            call()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total


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
    return worst


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
    """Flash-attention kernel against its plain version on the card."""
    gen = torch.Generator("cuda").manual_seed(1)
    worst = 0.0
    cases = ([(c, False) for c in FLASH_SWEEP] + [(c, True) for c in FLASH_YI]
             + [(c, False) for c in FLASH_OTHER])
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
    return worst


def random_norm_scales(params, gen) -> None:
    """Nonzero RMS-norm scales, so that (1 + scale) is exercised."""
    leaves = [params["final_norm"]]
    for block in params["blocks"].values():
        leaves += [block["ln1"], block["ln2"]]
    for leaf in leaves:
        leaf.copy_(0.2 * torch.randn(leaf.shape, generator=gen, device="cuda"))


def make_requests(rng, n, prompt_range, max_new, vocab):
    return [Request(rid=rid,
                    prompt=list(map(int, rng.integers(
                        0, vocab, int(rng.integers(*prompt_range))))),
                    max_new_tokens=max_new)
            for rid in range(n)]


def serve_check() -> None:
    """Engine completions equal offline greedy decode: yi-9b at full width,
    4 layers, float32."""
    cfg = dataclasses.replace(get_config(SERVE_ARCH), num_layers=CHECK_LAYERS,
                              compute_dtype="float32")
    params = init_params(lm.lm_param_specs(cfg), 0, "cuda", torch.float32)
    random_norm_scales(params, torch.Generator("cuda").manual_seed(2))
    engine = ServingEngine(cfg, params, max_slots=SERVE_SLOTS,
                           max_seq=CHECK_MAX_SEQ)
    reqs = make_requests(np.random.default_rng(0), CHECK_REQUESTS,
                         CHECK_PROMPT, CHECK_NEW, cfg.vocab_size)
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    done = engine.shutdown()
    wall_s = time.perf_counter() - t0
    mismatched = []
    for c in done:
        prompt, gen = c.tokens[:c.prompt_len], c.tokens[c.prompt_len:]
        if gen != offline_greedy(cfg, params, prompt, len(gen), CHECK_MAX_SEQ):
            mismatched.append(c.rid)
    ok = len(done) == CHECK_REQUESTS and not mismatched
    emit({"phase": "serve_check", "arch": SERVE_ARCH, "d_model": cfg.d_model,
          "num_layers": cfg.num_layers,
          "depth_cut": f"{CHECK_LAYERS} of {get_config(SERVE_ARCH).num_layers} layers",
          "compute_dtype": cfg.compute_dtype, "requests": len(done),
          "prompt_lens": sorted(c.prompt_len for c in done),
          "mismatched_rids": mismatched, "wall_s": wall_s, "ok": ok})
    if not ok:
        raise SystemExit(f"engine != offline greedy decode for {mismatched}")
    del engine, params
    torch.cuda.empty_cache()


def reset_launches() -> None:
    mandel_kernel.LAUNCHES = rms_kernel.LAUNCHES = flash_kernel.LAUNCHES = 0


def serve_full() -> dict:
    """yi-9b at full width and depth in bf16, through ServingEngine."""
    cfg = get_config(SERVE_ARCH)
    specs = lm.lm_param_specs(cfg)
    t0 = time.perf_counter()
    params = init_params(specs, 0, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # Warm-up (cuBLAS handles and bf16 algorithms): one short request.
    warm = ServingEngine(cfg, params, max_slots=SERVE_SLOTS,
                         max_seq=SERVE_MAX_SEQ)
    warm.submit(Request(rid=-1, prompt=list(range(1, 65)), max_new_tokens=2))
    warm.shutdown()
    del warm
    engine = ServingEngine(cfg, params, max_slots=SERVE_SLOTS,
                           max_seq=SERVE_MAX_SEQ)

    reqs = make_requests(np.random.default_rng(0), SERVE_REQUESTS,
                         SERVE_PROMPT, SERVE_NEW, cfg.vocab_size)
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
    half = SERVE_REQUESTS // 2
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
    launches = {"rmsnorm": rms_kernel.LAUNCHES, "flash": flash_kernel.LAUNCHES,
                "mandelbrot": mandel_kernel.LAUNCHES}
    done = engine.shutdown()

    prefills = len(done)
    prompt_lens = [c.prompt_len for c in sorted(done, key=lambda c: c.rid)]
    gen = [t for c in done for t in c.tokens[c.prompt_len:]]
    n_layers = cfg.num_layers
    expected = {"rmsnorm": (2 * n_layers + 1) * (prefills + ticks),
                "flash": n_layers * prefills, "mandelbrot": 0}
    lat = sorted(c.latency_s for c in done)
    decode_ms = engine.timing.node("host").run_ms
    summary = {
        "phase": "serve", "arch": SERVE_ARCH, "num_layers": n_layers,
        "d_model": cfg.d_model, "params": count_params(specs),
        "weights_dtype": "bfloat16", "init_params_s": init_s,
        "requests": prefills, "slots": SERVE_SLOTS, "max_seq": SERVE_MAX_SEQ,
        "prompt_lens": prompt_lens, "generated_tokens": len(gen),
        "wall_s": wall_s, "tokens_per_s": len(gen) / wall_s,
        "latency_p50_s": lat[len(lat) // 2],
        "latency_p99_s": lat[math.ceil(0.99 * len(lat)) - 1],
        "ticks": ticks, "decode_ms_per_tick": decode_ms / ticks,
        "prefill_ms_per_request": (step_s * 1e3 - decode_ms) / prefills,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "expected_launches": expected,
        "timing": engine.timing.summary(),
    }
    emit(summary)
    print(engine.timing.report(), flush=True)
    if len(done) != SERVE_REQUESTS or len(gen) != SERVE_REQUESTS * SERVE_NEW:
        raise SystemExit(f"served {len(done)} requests, {len(gen)} tokens")
    if not all(0 <= t < cfg.vocab_size for t in gen):
        raise SystemExit("a generated token lies outside [0, vocab)")
    if launches != expected:
        raise SystemExit(f"kernel launches {launches} != expected {expected}")
    del engine
    profile_serve(cfg, params, reqs, wall_s)
    del params
    torch.cuda.empty_cache()
    return {"cfg": cfg, "prompt_lens": prompt_lens, "ticks": ticks,
            "launches": launches}


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


def profile_serve(cfg, params, reqs, serve_wall_s: float) -> None:
    """Where the serve phase's time goes, from torch.profiler's kernel events.

    The same requests again give each kernel's device time; one decode tick
    and one prefill (at the prompts' mean length), each profiled alone,
    give their device time and kernel count.  The serve phase's own
    numbers come from its unprofiled run.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    engine = ServingEngine(cfg, params, max_slots=SERVE_SLOTS,
                           max_seq=SERVE_MAX_SEQ)
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
    cache = lm.init_cache(cfg, SERVE_SLOTS, SERVE_MAX_SEQ, device="cuda")
    tokens = torch.ones((SERVE_SLOTS, 1), dtype=torch.int64, device="cuda")
    lens = torch.full((SERVE_SLOTS,), mean_prompt, device="cuda")
    prompt = torch.ones((1, mean_prompt), dtype=torch.int64, device="cuda")
    alone = {}
    for name, fn in (
        ("decode_tick", lambda: lm.decode_step(cfg, params, cache, tokens, lens)),
        ("prefill", lambda: lm.prefill(cfg, params, prompt, SERVE_MAX_SEQ)),
    ):
        fn()  # warm-up
        torch.cuda.synchronize()
        with profile(activities=activities) as one:
            fn()
            torch.cuda.synchronize()
        us, n = kernel_events(one)
        alone[f"{name}_device_ms"] = sum(us.values()) / 1e3
        alone[f"{name}_kernels"] = n
    emit({"phase": "serve_profile", "profiled_wall_s": wall_s,
          "kernel_device_ms": total_ms, "kernels": kernels,
          "device_busy_share_profiled": total_ms / 1e3 / wall_s,
          "device_busy_share_of_serve_wall": total_ms / 1e3 / serve_wall_s,
          "rmsnorm_kernel_ms": share("rmsnorm_kernel"),
          "flash_kernel_ms": share("flash_kernel"),
          "top_kernels": [[k[:80], us / 1e3] for k, us in sorted(
              kernel_us.items(), key=lambda kv: -kv[1])[:10]],
          "prefill_tokens": mean_prompt, **alone})


def kernel_rows(serve: dict, rms_err: float, flash_err: float) -> list[dict]:
    """Time the serve phase's kernel work again, launch for launch, beside
    the plain version and a library call at the same shapes."""
    cfg = serve["cfg"]
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_pass = 2 * cfg.num_layers + 1
    bf16 = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(3)
    # RMS norm: [S, D] per prefill pass, [slots, D] per tick, scale in bf16.
    rows = [s for s in serve["prompt_lens"] for _ in range(per_pass)]
    rows += [SERVE_SLOTS] * (per_pass * serve["ticks"])
    scale = (0.2 * torch.randn((D,), generator=gen, device="cuda")).to(bf16)
    xs = {n: torch.randn((n, D), generator=gen, device="cuda").to(bf16)
          for n in set(rows)}
    weight = (1.0 + scale.float()).to(bf16)
    rms_calls = {
        "ms": [lambda n=n: rms_kernel.rms_norm_cuda(xs[n], scale) for n in rows],
        "plain_ms": [lambda n=n: rms_norm_reference(xs[n], scale) for n in rows],
        "library_ms": [lambda n=n: F.rms_norm(xs[n], (D,), weight, cfg.norm_eps)
                       for n in rows],
    }
    rms_bytes = sum(2 * n * D * 2 + D * 2 for n in rows)
    # Flash: one [1, H, S, hd] causal launch per layer per prefill, read in
    # place from [1, S, H, hd].
    lens = [s for s in serve["prompt_lens"] for _ in range(cfg.num_layers)]
    qkv = {s: flash_inputs(1, H, KV, s, s, hd, bf16, gen, True)
           for s in set(lens)}
    flash_calls = {
        "ms": [lambda s=s: flash_kernel.flash_attention_cuda(*qkv[s]) for s in lens],
        "plain_ms": [lambda s=s: flash_plain(*qkv[s], True, 0) for s in lens],
        "library_ms": [lambda s=s: F.scaled_dot_product_attention(
            *qkv[s], is_causal=True, enable_gqa=True) for s in lens],
    }
    flash_flops = sum(4 * H * hd * s * (s + 1) // 2 for s in lens)
    flash_bytes = sum(2 * s * (2 * H + 2 * KV) * hd for s in lens)

    out = []
    for name, src, replaces, calls, err, launches, ops_ms, bytes_ms in (
        ("rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm/kernel.py:21", rms_calls, rms_err,
         serve["launches"]["rmsnorm"], 0.0, rms_bytes / HBM_BYTES_PER_S * 1e3),
        ("flash_attention_forward",
         "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:32", flash_calls,
         flash_err, serve["launches"]["flash"],
         flash_flops / BF16_FLOPS_PER_S * 1e3,
         flash_bytes / HBM_BYTES_PER_S * 1e3),
    ):
        times = {}
        for key in ("ms", "plain_ms", "library_ms"):
            spun_device_ms(calls[key][:CALL_CHUNK], clock_hz)  # warm-up
            times[key] = spun_device_ms(calls[key], clock_hz)
        emit({"phase": "kernel_time", "kernel": name, "launches": len(calls["ms"]),
              **times, "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms})
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": times["ms"],
            "plain_ms": times["plain_ms"], "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": times["library_ms"],
        })
    return out


if __name__ == "__main__":
    main()
