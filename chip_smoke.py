"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch`` (one ``nvcc`` per
source, all at once) and drives the port's paths on the card:

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
4. Training: the gradients of the three model kernels held against their
   plain versions (the RMS-norm backward kernel; the RG-LRU backward
   kernel, bit-equal to the flip construction over ``rglru_scan_chunked``
   at the plan's chunk length; the flash backward kernel against
   ``flash_backward_reference`` and the explicit gradient in f32, each case
   twice and bit-equal, and the flash Function, both kernels, against
   autograd of the plain forward); the ``Trainer`` on recurrentgemma-2b's
   smoke config in float32 under ``torch.use_deterministic_algorithms``,
   with a crash injected mid-run (the replayed losses bit-identical) and
   its losses against the port's own CPU run from the same checkpoint;
   the AdamW kernel held bit for bit to the plain loop at olmoe-1b-7b's
   leaf shapes and at sizes with a tail or off a 16-byte boundary, every
   pair of parameter and state dtypes, one launch a leaf, then timed over
   the benchmark's training tree (``adamw``: the kernel against its bound,
   the plain loop and ``torch._fused_adamw_``);
   then ``make_train_step`` at recurrentgemma-2b's full width and depth
   (26 layers, bf16 compute, f32 parameters and AdamW state, B 1 x S 2048),
   where each step's kernel launches are counted (one AdamW launch a leaf;
   no training phase may call the explicit flash gradient on the card); then the same step under
   ``remat_policy="dots"``: one forward and backward under each policy
   from the same parameters, bit for bit equal, and timed steps with their
   launches (the same as under ``"nothing"``), device time and peak memory.
5. The other block families, at full width: olmoe-1b-7b (MoE, 64 experts
   top-8) cut to 2 layers in float32 (engine == offline greedy), then
   served at full depth in bf16 with its prompts' drop fractions and a
   profiled repeat that splits the device time into attention, routing
   and dispatch, expert products and the rest; llama4-maverick cut to one
   period (attn, moe) in bf16 (engine == offline greedy); xlstm-350m cut to
   one mLSTM and one sLSTM layer in float32 (engine == offline greedy),
   then served at full depth in bf16 and trained 2 steps at 8 of its 24
   layers; olmoe-1b-7b
   trained at 6 layers under deterministic algorithms (a replayed forward
   and backward bit for bit); seamless-m4t-large-v2 cut to 4 + 4 layers
   in float32 (greedy decode steps == the full forward within 2e-4), then
   encoding, decoding and one train step at full depth; internvl2-2b
   trained at full depth with its ViT stub's 256 embeddings, and one bf16
   prefill step with them.  Every phase's RMS-norm and flash launches must
   equal the counts its layer kinds give; each path's launches are then
   replayed at their shapes, beside the bound of the same work and the
   library call on the same inputs (``by_path`` in the kernels line).
6. Sharding on one card (a one-rank process group, a 1 x 1 mesh):
   recurrentgemma-2b's full-width train step traced by
   ``ClusterBuilder.build_step`` with ``training_rules`` (fake tensors: no
   allocation) and run on DTensor parameters from ``init_params(...,
   rules=)``, its loss and grad norm equal to part 4's unsharded steps,
   its launches exact, its predicted memory and traced FLOPs beside the
   measured peak and the analytic model FLOPs (MFU); olmoe-1b-7b cut to 2
   layers under ``"dots"``, one forward and backward on DTensors through
   the expert-parallel MoE path, bit for bit the plain pass; yi-9b served through
   ``ServingEngine(rules=decode_rules(mesh))`` beside the engine without
   rules (tokens equal; a float32 depth cut equal to offline greedy); the
   padded tp = 16 plans of phi3-medium-14b (grouped, 48 / 12 heads) and
   llama4-maverick (``expand_kv``, 48 over 8) in float32 against tp = 1
   (logits within 2e-4, tokens equal, every flash launch at 48 query
   heads); and ``python -m repro_torch.launch.dryrun`` / ``roofline`` for
   yi-9b on the 16 x 16 fake mesh, run on the host with no device memory
   left behind.

7. DeepSeek-V2-Lite's latent attention, also alone (``python3
   chip_smoke.py mla``): the RMS-norm kernel at the latent's width 512
   (a tick's rows and a prompt's, bit-equal across launches of 1, 4 and
   1,000 rows); the prefill's flash call as the model makes it (MHA 16 /
   16, q and k 192 and v 128 zero-padded to 256, causal, the published
   scale 192^-0.5 m^2) at S 1,024, 3,072 and 7,168 against the plain
   version at the true widths (bf16, the model's dtype, at the usual
   tolerances; f32 held to float64, no further from it than the plain
   version by more than the tolerance); then ``ServingEngine`` serving
   the model at full width and depth (27 layers, bf16, prompts of
   1,024-7,168 tokens) with its RMS-norm and flash launches counted from
   zero.

Each phase prints one JSON line; any failure exits non-zero.  The line
before the last lists every kernel with its launches on its path, its
device time at that path's shapes, its bound, its plain version's time and
a library call's (RMS norm and RG-LRU also split into their prefill and
decode-tick launches, beside the time of as many launches at the least
shape; the two backward kernels at the training path's shapes; RMS norm
and flash also ``by_path``, their launches and device time on each path
of part 5, and the flash backward's on each training path; AdamW on the
benchmark's training tree, with ``path_ms`` for the whole of
``apply_updates``); the last
line is the run's verdict.

Without a CUDA device, or without the repository around it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib.metadata
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# Deterministic cuBLAS for the trainer phase, set before torch first uses
# cuBLAS (torch.use_deterministic_algorithms refuses cuBLAS without it).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script measures the card only")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.cluster.deploy.local import LocalLauncher, _child_env  # noqa: E402
from repro_torch.cluster.service import ClusterService  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.adamw import kernel as adamw_kernel  # noqa: E402
from repro_torch.kernels.adamw import ref as adamw_ref  # noqa: E402
from repro_torch.core.builder import ClusterBuilder  # noqa: E402
from repro_torch.core.verify import verify_spec  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_backward_reference,
    attention_lse_reference,
    attention_reference,
    flash_backward_reference,
)
from repro_torch.kernels.mandelbrot import kernel as mandel_kernel  # noqa: E402
from repro_torch.kernels.mandelbrot.ops import mandelbrot_line_stats  # noqa: E402
from repro_torch.kernels.mandelbrot.ref import (  # noqa: E402
    grid_coords,
    mandelbrot_reference,
)
from repro_torch.kernels.rglru import kernel as rglru_kernel  # noqa: E402
from repro_torch.kernels.rglru.ref import (  # noqa: E402
    rglru_scan_backward,
    rglru_scan_backward_reference,
    rglru_scan_chunked,
    rglru_scan_reference,
)
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import (  # noqa: E402
    rms_norm_backward_reference,
    rms_norm_reference,
)
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
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
from repro_torch.configs.base import TRAIN_4K, ShapeConfig  # noqa: E402
from repro_torch.core.channels import decode_rules, training_rules  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW,
    PEAK_FLOPS_BF16,
    make_smoke_mesh,
)
from repro_torch.models.convert import pad_for_tp  # noqa: E402
from repro_torch.models.flops import step_flops  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, SyntheticLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import steps as steps_mod  # noqa: E402
from repro_torch.runtime.executor import Trainer, TrainerConfig  # noqa: E402
from repro_torch.runtime.failures import FailureEvent, FailurePlan  # noqa: E402
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serve_pipeline import offline_greedy  # noqa: E402

# H100 SXM: 132 SMs of 128 FP32 lanes; FP32 outside the tensor cores 67
# TFLOP/s (NVIDIA data sheet); HBM3 bandwidth and the dense bf16 tensor-core
# peak come from the port's one source of them, ``launch/mesh.py``.
SMS = 132
FP32_LANES = 128
HBM_BYTES_PER_S = HBM_BW
BF16_FLOPS_PER_S = PEAK_FLOPS_BF16
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
# prompt's and one row; then the other families' widths: 1,024 (xlstm-350m,
# seamless-m4t-large-v2), 2,048 (olmoe-1b-7b, internvl2-2b) and 5,120
# (llama4-maverick) at a tick's rows and a prompt's or training step's.
RMS_SHAPES = [(9, 77), (128, 4096), (1000, 4096), (4, 4096), (1, 4096),
              (4, 2560), (3000, 2560), (4, 1024), (2048, 1024), (4, 2048),
              (2048, 2048), (1, 5120), (512, 5120)]
# Row invariance: the first rows of a [1000, D] launch, normalised again in
# launches of 1 and 4 rows, must come out the same bits, at every served D.
RMS_INVARIANCE_ROWS = (1, 4, 1000)
RMS_SERVED_D = (4096, 2560, 2048, 1024, 5120)
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
# The other families, in the model's layout: seamless-m4t-large-v2's encoder
# (non-causal), its cross-attention (256 queries over 1,024 encoder keys)
# and its decoder (causal) at head_dim 64; olmoe-1b-7b's MHA at S 2,048;
# llama4-maverick's GQA 40/8 (a group of 5) at 512; internvl2-2b's GQA 16/8
# at S 2,048, all three at head_dim 128.
FLASH_SLICE = [(1, 16, 16, 1024, 1024, 64, False, 0),
               (1, 16, 16, 256, 1024, 64, False, 0),
               (1, 16, 16, 1024, 1024, 64, True, 0),
               (1, 16, 16, 2048, 2048, 128, True, 0),
               (1, 40, 8, 512, 512, 128, True, 0),
               (1, 16, 8, 2048, 2048, 128, True, 0)]
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
# DeepSeek-V2-Lite's latent attention (MLA), as its serving path calls the
# kernels: each prefill's flash call is MHA 16 / 16, causal, no window, its
# q and k (192 wide) and v (128) zero-padded to 256, at the published scale
# 192^-0.5 m^2 (YaRN's m), at prompt lengths across the benchmark cell's
# 1,024-7,168 (b, h, kv, s, dqk, dv); the latent's RMS norm is 512 wide, at
# a tick's rows (4 here, 64 in the cell) and a 7,168-token prompt's.  The
# bf16 cases, the model's, are held to the plain version at FLASH_TOL and
# RMS_TOL.  In f32 the two versions differ by a few ulp more than those
# tolerances allow at these shapes (the flash scale is 1.8x 256^-0.5, the
# latent rows' norms vary more), as the plain version differs from the
# same formula in float64; so an f32 case is held to float64: the kernel's
# error may pass the plain version's by the tolerance, no more.  Then the
# model served at full width and depth (bf16, 4 slots x 8,192 positions)
# with its launches counted.
DSV2 = "deepseek-v2-lite"
MLA_FLASH = [(1, 16, 16, s, 192, 128) for s in (1024, 3072, 7168)]
MLA_RMS_D = 512
MLA_RMS_SHAPES = [(4, MLA_RMS_D), (64, MLA_RMS_D), (7168, MLA_RMS_D)]
MLA_SERVE_PROMPT, MLA_SERVE_MAX_SEQ = (1024, 7169), 8192
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

# Training.  Backward checks: RMS norm at every trained width and a ragged
# one; RG-LRU at S around the chunk length and the training path's S; flash
# at recurrentgemma-2b's training shape, a small GQA window and yi-9b's
# grouping.  The trainer phase runs recurrentgemma-2b's smoke config in
# float32; the full-width phase the whole model at B 1 x S 2048, cut from
# the train_4k shape (S 4096, batch 256) to fit one card's 80 GB.
RMS_BWD_SHAPES = [(9, 77), (2048, 2560), (2048, 4096), (4, 64), (2048, 1024),
                  (2048, 2048), (512, 5120)]
# The RG-LRU backward at S around the chunk lengths 16 and 32 and past the
# 32-step chunks it holds in registers (S > 2,048), at the model's W and a
# ragged one, B 1 and 3, with and without h0, a (and h) in f32 and bf16.
RGLRU_BWD_S = (1, 15, 16, 17, 53, 1000, 2048, 3000)
RGLRU_BWD_W, RGLRU_BWD_B = (2560, 200), (1, 3)
FLASH_BWD = [(1, 10, 1, 2048, 256, 2048), (1, 4, 2, 50, 16, 32), (1, 32, 4, 1000, 128, 0)]
# The backward kernel alone (b, h, kv, sq, skv, d, causal, window): FLASH_BWD's
# three; seamless's encoder (non-causal) and a cross-attention of 1,024
# queries over 700 keys at head_dim 64; internvl2-2b's GQA 16 / 8 at S
# 2,304 and olmoe's 16 / 16 at 2,048, head_dim 128; head_dim 32 at a ragged
# S of 77; recurrentgemma-2b at S 3,000 with its window of 2,048.
FLASH_BWD_KERNEL = ([(b, h, kv, s, s, d, True, w) for b, h, kv, s, d, w in FLASH_BWD]
                    + [(1, 16, 16, 1024, 1024, 64, False, 0),
                       (1, 16, 16, 1024, 700, 64, False, 0),
                       (1, 16, 8, 2304, 2304, 128, True, 0),
                       (1, 16, 16, 2048, 2048, 128, True, 0),
                       (1, 4, 2, 77, 77, 32, True, 0),
                       (1, 10, 1, 3000, 3000, 256, True, 2048)])
# Gradients are compared as |got - want| <= tol * max(1, |want|): at S 2048
# dV and dK reach 8-16, where one bf16 spacing is 0.0625.
FLASH_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The forward kernel's log-sum-exp against attention_lse_reference, absolute:
# values of 8-16 (one float32 spacing 9.5e-7), each a sum of up to 3,000
# exponentials taken in another order.
FLASH_LSE_TOL = 1e-5
TRAINER_SEQ, TRAINER_BATCH, TRAINER_STEPS = 64, 4, 8
TRAINER_CKPT_EVERY, TRAINER_CRASH_AT, TRAINER_TOL = 3, 5, 1e-4
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 2048, 1, 3
# train_full_dots: timed steps under remat_policy="dots", and the kernel
# names its profile counts as the cuBLAS products.
DOTS_STEPS = 2
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")

# The other block families, after the training phases, all at full width.
# olmoe-1b-7b: a 2-layer float32 check at the config's capacity factor of
# 1.25, then full depth in bf16 with the serve phases' request mix.
# llama4-maverick: one period (attn, moe) of 48 layers, bf16 (37 GB),
# engine with one slot against offline greedy: a batch-1 tick rounds as the
# offline decode does, where bf16 batch-4 ticks would not.  xlstm-350m: a
# check cut to one mLSTM and one sLSTM layer in float32, then full depth in
# bf16, and 2 train steps at 8 of 24 layers (at full depth the sLSTM's
# loop took 96 s of the script's time).  olmoe-1b-7b trained at 6 of 16 layers (f32
# state of full depth, about 111 GB, is more than the card holds).
# seamless-m4t-large-v2: a 4 + 4-layer float32 check, then full depth in
# bf16 and one train step.  internvl2-2b: full depth, trained with its 256
# ViT-stub embeddings, and one bf16 prefill step with them.
OLMOE, MAVERICK = "olmoe-1b-7b", "llama4-maverick-400b-a17b"
XLSTM, SEAMLESS, VLM = "xlstm-350m", "seamless-m4t-large-v2", "internvl2-2b"
MOE_CHECK_LAYERS, MAVERICK_LAYERS, MOE_TRAIN_LAYERS = 2, 2, 6
MAVERICK_REQUESTS, MAVERICK_PROMPT, MAVERICK_MAX_SEQ = 4, (64, 513), 1024
XLSTM_CHECK_PATTERN = ("mlstm", "slstm")
XLSTM_TRAIN_STEPS, MOE_TRAIN_STEPS, VLM_TRAIN_STEPS = 2, 3, 2
XLSTM_TRAIN_LAYERS = 8  # of 24: two periods of (mlstm x 3, slstm)
ENCDEC_CHECK_LAYERS, ENCDEC_CHECK_FRAMES, ENCDEC_CHECK_TOKENS = 4, 64, 12
ENCDEC_TOL = 2e-4  # tests/test_archs.py::test_encdec_decode_matches_forward
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_NEW, ENCDEC_TRAIN_SEQ = 2, 1024, 32, 1024

# Part 6, sharding on one card.  spmd_train: recurrentgemma-2b's train_full
# step again over a one-device mesh, DTensor parameters; equal to the
# unsharded step within SPMD_TOL relative (the same kernels on the same
# shards).  tp_plan: the padded plans at tp 16 in float32, logits within
# TP_TOL (tests/test_archs.py's padding tolerance) of tp 1's.
SPMD_TOL = 1e-6
MOE_SPMD_LAYERS = 2
PHI3 = "phi3-medium-14b"
TP_PLAN, TP_TOL = 16, 2e-4
TP_PLAN_PROMPT, TP_PLAN_NEW, TP_PLAN_MAX_SEQ = 256, 8, 512
DRYRUN_TIMEOUT_S = 600

# AdamW (kernels/adamw), checked bit for bit against the plain loop over two
# steps from the same values: at olmoe-1b-7b's leaf shapes (the stacked
# layers cut to one), every pair of parameter and state dtypes; then at
# sizes that leave a tail past the kernel's 8-element vectors, under each
# clipping norm, each also as a view one element off its allocation (off a
# 16-byte boundary: the scalar loop).  Timed on the whole tree of the
# benchmark's training cell: olmoe-1b-7b at 8 layers, f32 parameters and
# state, 3.56 B parameters.
ADAMW_DTYPES = [(p, s) for p in (torch.float32, torch.bfloat16)
                for s in ("float32", "bfloat16")]
ADAMW_ODD_SIZES = (1, 7, 4099, (1 << 16) + 3)
ADAMW_CLIPS = (1.0, 0.0, 1e3)
ADAMW_PATH_LAYERS, ADAMW_REPS = 8, 3
ADAMW_BYTES = 28  # a parameter's f32 p, g, m and v read, p, m and v written


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
    memory, spills and any wgmma pipeline it serialised, built with the
    flags of the library the run loads."""
    cubin = _build.BUILD_DIR / f"{source.stem}-ptxas.cubin"
    cubin.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", *flags, "-Xptxas", "-v", "-cubin",
         "-o", str(cubin), str(source)],
        check=True, capture_output=True, text=True)
    return [line.split("ptxas info    : ")[-1] for line in proc.stderr.splitlines()
            if any(w in line for w in ("registers", "spill", "Compiling entry",
                                       "Performance Loss"))]


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


def build_kernels() -> None:
    """Every kernel's library, one nvcc each, all at once; beside them the
    ptxas report of the sources whose registers and spills are watched."""

    def timed_load(load):
        t = time.perf_counter()
        load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(13) as pool:
        builds = {name: pool.submit(timed_load, load) for name, load in (
            ("mandelbrot", mandel_kernel.load), ("rmsnorm", rms_kernel.load),
            ("rmsnorm_backward", rms_kernel.load_backward),
            ("flash_attention", flash_kernel.load),
            ("flash_attention_backward", flash_kernel.load_backward),
            ("rglru", rglru_kernel.load),
            ("rglru_backward", rglru_kernel.load_backward),
            ("adamw", adamw_kernel.load))}
        ptxas = {f"{name}_ptxas": pool.submit(ptxas_report, source, flags)
                 for name, source, flags in (
                     ("mandelbrot", mandel_kernel.SOURCE, mandel_kernel.FLAGS),
                     ("rmsnorm", rms_kernel.SOURCE, ()),
                     ("rmsnorm_backward", rms_kernel.BACKWARD_SOURCE, ()),
                     ("flash_attention_backward", flash_kernel.BACKWARD_SOURCE, ()),
                     ("rglru", rglru_kernel.SOURCE, ()),
                     ("rglru_backward", rglru_kernel.BACKWARD_SOURCE, ()),
                     ("adamw", adamw_kernel.SOURCE, adamw_kernel.FLAGS))}
        seconds = {name: f.result() for name, f in builds.items()}
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "per_kernel_s": seconds,
              **{key: f.result() for key, f in ptxas.items()}})


def start() -> tuple[str, str, float]:
    """The card's name, its nvidia-smi line and its max SM clock in Hz;
    TF32 off and every kernel built."""
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
    build_kernels()
    return kind, card, max_clock_hz


def verdict(kind: str) -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def main_mla() -> None:
    """``python3 chip_smoke.py mla``: part 7 alone."""
    kind, card, _clock = start()
    mla_phases()
    print(card, flush=True)
    verdict(kind)


def main() -> None:
    kind, card, max_clock_hz = start()
    watch_explicit_flash_gradient()

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
    serve_check(YI, "serve_check", cut(YI, YI_CHECK_LAYERS), YI_CHECK_MAX_SEQ,
                lambda rng, vocab: make_requests(
                    rng, CHECK_REQUESTS, YI_CHECK_PROMPT, CHECK_NEW, vocab))
    serves = {YI: serve_full(YI, "serve", YI_SERVE_MAX_SEQ,
                             lambda rng, vocab: make_requests(
                                 rng, SERVE_REQUESTS, YI_SERVE_PROMPT,
                                 SERVE_NEW, vocab), profile=False)}
    serve_check(RG, "serve_check_rg", cut(RG, RG_CHECK_LAYERS), RG_MAX_SEQ,
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

    # Training: the backward checks, the trainer, then the main training
    # path at full width (its launches counted from zero just before it).
    bwd_errs = {"rmsnorm_backward": check_rmsnorm_backward(),
                "rglru_backward": check_rglru_backward(),
                "flash_backward": max(check_flash_backward_kernel(), check_flash_backward())}
    train_trainer()
    adamw_row = check_adamw()
    train = train_full()
    rows += train_kernel_rows(train, bwd_errs,
                              float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6)
    rows.append(adamw_row)

    # The other block families, each path's launches counted from zero;
    # their RMS-norm and flash launches join those rows under "by_path".
    new_paths = by_path(other_families())
    spmd_phases(train)
    mla_phases()
    for row in rows:
        key = {"rmsnorm": "rmsnorm", "flash_attention_forward": "flash",
               "flash_attention_backward": "flash_backward"}.get(row["name"])
        if key:
            row["by_path"] = new_paths[key]
    print(card, flush=True)
    emit({"kernels": [mandel_row, *rows]})
    verdict(kind)


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
    check_rmsnorm_row_invariance(gen, RMS_SERVED_D)
    count_rsqrt_rounding(gen)
    return worst


def check_rmsnorm_row_invariance(gen, served_d) -> None:
    """The same rows give the same bits in launches of 1, 4 and 1,000 rows,
    at every served width: a batch-4 tick must normalise a request's row as
    its batch-1 prefill and offline decode do."""
    for d in served_d:
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
             + [(c, c[6]) for c in FLASH_EDGE] + [(c, True) for c in FLASH_SLICE])
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


def mla_verdict(phase: str, got, want, exact, dtype, tol: dict, **fields) -> float:
    """Emit one MLA case and exit on a fault: a bf16 case within ``tol``
    of the plain version ``want``; an f32 case no further from ``exact``
    (float64) than the plain version is, plus ``tol``.  Returns the error
    against the plain version."""
    err = float((got.float() - want.float()).abs().max())
    kernel_f64 = float((got.double() - exact).abs().max())
    plain_f64 = float((want.double() - exact).abs().max())
    held = err if dtype == torch.bfloat16 else kernel_f64 - plain_f64
    ok = (got.dtype == dtype and bool(torch.isfinite(got).all())
          and held <= tol[dtype])
    emit({"phase": phase, **fields, "dtype": str(dtype), "max_abs_err": err,
          "kernel_vs_f64": kernel_f64, "plain_vs_f64": plain_f64,
          "held_to": "plain" if dtype == torch.bfloat16 else "f64",
          "tol": tol[dtype], "ok": ok})
    if not ok:
        raise SystemExit(f"{phase} differs at {fields} {dtype}")
    return err


def check_mla_rmsnorm() -> float:
    """RMS norm at the latent's width, every dtype pair the checks use;
    then bit-equal rows across launches of 1, 4 and 1,000 rows."""
    gen = torch.Generator("cuda").manual_seed(4)
    worst = 0.0
    for xdt, sdt in RMS_DTYPES:
        for n, d in MLA_RMS_SHAPES:
            x = torch.randn((n, d), generator=gen, device="cuda").to(xdt)
            scale = (0.2 * torch.randn((d,), generator=gen, device="cuda")).to(sdt)
            got = rms_kernel.rms_norm_cuda(x, scale)
            want = rms_norm_reference(x, scale)
            xd = x.double()
            exact = (xd * torch.rsqrt((xd * xd).mean(-1, keepdim=True) + 1e-6)
                     * (1 + scale.double()))
            torch.cuda.synchronize()
            worst = max(worst, mla_verdict("mla_rmsnorm_vs_plain", got, want, exact, xdt,
                                           RMS_TOL, shape=[n, d], scale_dtype=str(sdt)))
    check_rmsnorm_row_invariance(gen, (MLA_RMS_D,))
    return worst


def exact_attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal attention in float64, q, k [B, S, H, Dqk], v [B, S, H, Dv]."""
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", qd, kd) * scale
    s = q.shape[1]
    scores.masked_fill_(torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1),
                        float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), vd).transpose(1, 2)


def check_mla_flash() -> float:
    """The latent attention's prefill call on the card, as the model makes
    it (``padded_attention``: q, k and v zero-padded to 256 in the model's
    layout, the published scale passed to the kernel), against the plain
    version at the true widths (q, k 192 and v 128, the same scale); the
    output is cut back to v's width by the call, so the padded columns
    must not leak into it.  float32 through the f32 variant and bfloat16
    through wgmma, one launch a call."""
    cfg = get_config(DSV2)
    scale = attn_mod.yarn_softmax_scale(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                                        cfg.rope_scaling)
    gen = torch.Generator("cuda").manual_seed(3)
    worst = 0.0
    before = dict(flash_kernel.LAUNCHES_BY_VARIANT)
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, kv, s, dqk, dv in MLA_FLASH:
            q, k = (torch.randn((b, s, n, dqk), generator=gen, device="cuda").to(dtype)
                    for n in (h, kv))
            v = torch.randn((b, s, kv, dv), generator=gen, device="cuda").to(dtype)
            got = attn_mod.padded_attention(q, k, v, scale=scale)
            want = attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=True,
                                       scale=scale).transpose(1, 2)
            exact = exact_attention(q, k, v, scale)
            torch.cuda.synchronize()
            if got.shape != want.shape:
                raise SystemExit(f"MLA flash call gave {tuple(got.shape)}, "
                                 f"not {tuple(want.shape)}")
            worst = max(worst, mla_verdict(
                "mla_flash_vs_plain", got, want, exact, dtype, FLASH_TOL,
                shape=[b, h, kv, s, s], qk_dim=dqk, v_dim=dv, padded_to=256,
                scale=scale, causal=True, window=0))
            del exact
    ran = {x: n - before[x] for x, n in flash_kernel.LAUNCHES_BY_VARIANT.items()}
    if ran != {"wgmma": len(MLA_FLASH), "f32": len(MLA_FLASH)}:
        raise SystemExit(f"MLA flash checks ran {ran}, expected {len(MLA_FLASH)} of each")
    return worst


def mla_phases() -> dict:
    """DeepSeek-V2-Lite's kernels at its shapes (the latent's RMS norm,
    with row invariance; the padded flash call at its scale), then the
    model served at full width and depth with its launches counted from
    zero: per prefill and tick 3 norms a layer and the final norm, per
    prefill 27 flash launches, all wgmma."""
    errs = {"rmsnorm": check_mla_rmsnorm(), "flash": check_mla_flash()}
    serve = serve_full(DSV2, "serve_mla", MLA_SERVE_MAX_SEQ,
                       lambda rng, vocab: make_requests(
                           rng, SERVE_REQUESTS, MLA_SERVE_PROMPT, SERVE_NEW, vocab),
                       profile=False)
    emit({"phase": "mla", "max_abs_err": errs, "launches": serve["launches"],
          "ticks": serve["ticks"], "prompt_lens": serve["prompt_lens"]})
    return errs


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
    """Nonzero RMS-norm scales, so that (1 + scale) is exercised, nonzero
    RG-LRU gate biases and xLSTM group-norm scales; for an encoder-decoder,
    every norm of its encoder and decoder."""
    stacks = ([params["encoder"], params["decoder"]] if "encoder" in params
              else [params])
    leaves = []
    for stack in stacks:
        leaves.append(stack["final_norm"])
        blocks = stack["blocks"]
        for block in ([blocks] if "encoder" in params else blocks.values()):
            leaves += [block[k] for k in ("ln1", "ln2", "ln_x") if k in block]
            if "rec" in block:
                leaves += [block["rec"]["rglru"]["b_a"], block["rec"]["rglru"]["b_x"]]
            if "core" in block:
                leaves.append(block["core"]["norm"])
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


def cut(arch: str, layers: int, **changes):
    """``arch`` at full width cut to ``layers`` layers, in float32 unless
    ``changes`` say otherwise."""
    return dataclasses.replace(get_config(arch), num_layers=layers,
                               **{"compute_dtype": "float32", **changes})


def serve_check(arch: str, phase: str, cfg, max_seq: int, make,
                slots: int = SERVE_SLOTS) -> dict:
    """Engine completions equal offline greedy decode: ``cfg`` (``arch``
    cut in depth, weights in its compute dtype).  The kernels' launches
    over the engine's run and the offline decodes must equal the expected
    counts, every flash launch through the variant of the dtype."""
    dtype = getattr(torch, cfg.compute_dtype)
    params = init_params(lm.lm_param_specs(cfg), 0, "cuda", dtype)
    randomize_small_params(params, torch.Generator("cuda").manual_seed(2))
    engine = ServingEngine(cfg, params, max_slots=slots, max_seq=max_seq)
    reqs = make(np.random.default_rng(0), cfg.vocab_size)
    torch.cuda.synchronize()
    reset_launches()
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    ticks = 0
    while engine.queue or (engine.slot_rid >= 0).any():
        ticks += engine.step() > 0
    done = engine.shutdown()
    wall_s = time.perf_counter() - t0
    mismatched, offline_steps = [], 0
    for c in done:
        prompt, gen = c.tokens[:c.prompt_len], c.tokens[c.prompt_len:]
        offline_steps += len(gen) - 1
        if gen != offline_greedy(cfg, params, prompt, len(gen), max_seq):
            mismatched.append(c.rid)
    torch.cuda.synchronize()
    launches = {name: module.LAUNCHES for name, module in KERNELS.items()}
    variants = dict(flash_kernel.LAUNCHES_BY_VARIANT)
    expected = expected_launches(cfg, 2 * len(done), ticks + offline_steps)
    variant = flash_kernel.VARIANTS[dtype]
    want_variants = {v: expected["flash"] if v == variant else 0 for v in variants}
    ok = (len(done) == len(reqs) and not mismatched and launches == expected
          and variants == want_variants)
    lens = sorted(c.prompt_len for c in done)
    emit({"phase": phase, "arch": arch, "d_model": cfg.d_model,
          "num_layers": cfg.num_layers, "layer_kinds": cfg.layer_counts(),
          "depth_cut": f"{cfg.num_layers} of {get_config(arch).num_layers} layers",
          "compute_dtype": cfg.compute_dtype, "requests": len(done), "slots": slots,
          "max_seq": max_seq, "prompt_lens": lens,
          "prompts_past_window": sum(n > cfg.window_size > 0 for n in lens),
          "engine_ticks": ticks, "offline_decode_steps": offline_steps,
          "launches": launches, "expected_launches": expected,
          "flash_launches_by_variant": variants,
          "mismatched_rids": mismatched, "wall_s": wall_s, "ok": ok})
    if not ok:
        raise SystemExit(f"{arch}: engine != offline greedy decode for {mismatched}, "
                         f"or launches {launches} {variants} != {expected}")
    del engine, params
    torch.cuda.empty_cache()
    return {"cfg": cfg, "prefill_lens": [c.prompt_len for c in done] * 2,
            "tick_rows": [slots] * ticks + [1] * offline_steps,
            "launches": launches}


KERNELS = {"mandelbrot": mandel_kernel, "rmsnorm": rms_kernel,
           "flash": flash_kernel, "rglru": rglru_kernel}


def reset_launches() -> None:
    for module in KERNELS.values():
        module.LAUNCHES = 0
    rms_kernel.BACKWARD_LAUNCHES = rglru_kernel.BACKWARD_LAUNCHES = 0
    flash_kernel.BACKWARD_LAUNCHES = 0
    flash_kernel.LAUNCHES_BY_VARIANT = dict.fromkeys(flash_kernel.LAUNCHES_BY_VARIANT, 0)
    flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT = dict.fromkeys(
        flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT, 0)
    EXPLICIT_FLASH_GRADIENT["on_cuda"] = 0


def block_norms(cfg, kind: str) -> int:
    """RMS-norm launches of one block of ``kind``: ln1; ln2 where the block
    has an FFN (a ``moe`` or ``mla_moe`` block always, an attention, latent
    attention or ``rec`` block where d_ff > 0, an xLSTM block never); q and
    k norms in attention blocks of a config with qk-norm; the latent's norm
    in a latent-attention block."""
    n = 1 + (kind in lm.MOE_KINDS or (kind not in ("mlstm", "slstm") and cfg.d_ff > 0))
    return (n + 2 * (kind in lm.ATTN_KINDS and cfg.use_qk_norm)
            + (kind in lm.MLA_KINDS))


def pass_norms(cfg) -> int:
    """RMS-norm launches of one pass over the whole model: every block's
    and final_norm."""
    return sum(block_norms(cfg, kind) * n for kind, n in cfg.layer_counts().items()) + 1


def attention_layers(cfg) -> int:
    """Layers whose prefill makes one flash launch: attention and latent
    attention."""
    return sum(n for kind, n in cfg.layer_counts().items()
               if kind in lm.ATTN_KINDS + lm.MLA_KINDS)


def expected_launches(cfg, prefills: int, ticks: int) -> dict[str, int]:
    """Per prefill pass and per tick: ``pass_norms``; one flash launch per
    attention-kind layer (``moe`` and the latent kinds included) per prefill; one RG-LRU launch
    per rec layer per prefill and per tick.  xLSTM layers launch no kernel
    but their norm."""
    rec = cfg.layer_counts().get("rec", 0)
    return {"mandelbrot": 0,
            "rmsnorm": pass_norms(cfg) * (prefills + ticks),
            "flash": attention_layers(cfg) * prefills,
            "rglru": rec * (prefills + ticks)}


def serve_full(arch: str, phase: str, max_seq: int, make,
               profile: bool) -> dict:
    """``arch`` at full width and depth in bf16, through ServingEngine;
    with ``profile``, a profiled repeat follows.  For a MoE model, each
    prompt's forward is run once more after the counted run to read its
    slots' drop fraction."""
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
    moe_layers = cfg.layer_counts().get("moe", 0)
    if moe_layers:
        drops = []
        for r in reqs:
            _x, aux = lm.forward_hidden(cfg, params, torch.tensor(
                [r.prompt], dtype=torch.int64, device="cuda"))
            drops.append(float(aux["moe_drop_fraction"]) / moe_layers)
        emit({"phase": phase + "_drops", "arch": arch,
              "capacity_factor": cfg.capacity_factor,
              "prompt_lens": [len(r.prompt) for r in reqs],
              "drop_fraction_per_prompt": drops,
              "drop_fraction_mean": statistics.mean(drops),
              "decode_capacity_per_row_and_expert": max(
                  int(cfg.capacity_factor * cfg.experts_per_token / cfg.num_experts), 1)})
    if profile:
        profile_serve(cfg, params, reqs, wall_s, max_seq, phase + "_profile")
    del params
    torch.cuda.empty_cache()
    return {"cfg": cfg, "prompt_lens": prompt_lens, "ticks": ticks,
            "launches": launches, "flash_variants": flash_variants,
            "prefill_lens": prompt_lens, "tick_rows": [SERVE_SLOTS] * ticks}


# The model's profiler spans (``record_function``): their device-side
# annotations are ranges, not kernels.
SPANS = ("attention", "moe_ffn", "moe_experts")


def device_events(prof) -> tuple[dict[str, float], int, dict[str, dict[str, float]]]:
    """Device µs by kernel name, the number of kernels, and each model
    span's device time, read from the profiler's raw events.

    A span's ``kernels_ms`` sums the kernels launched by the host ops that
    start inside its host-side range on the same thread; its ``range_ms``
    is the device-side range's length, idle gaps inside it included.
    ``key_averages()`` gives the same sums, but first builds a Python tree
    of every event: 88–110 s for a serve run's 125–153 k kernels on the
    H100."""
    cuda = torch.autograd.DeviceType.CUDA
    kernel_us: dict[str, float] = {}
    spans = {name: {"kernels_ms": 0.0, "range_ms": 0.0, "calls": 0} for name in SPANS}
    ranges: dict[str, dict[int, list]] = {name: {} for name in SPANS}
    op_start: dict[int, tuple[int, int]] = {}  # host op id -> (thread, start ns)
    kernels: list[tuple[int, int]] = []  # (launching op id, ns)
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        if evt.device_type() == cuda:
            if name in SPANS:
                spans[name]["range_ms"] += evt.duration_ns() / 1e6
                continue
            kernel_us[name] = kernel_us.get(name, 0.0) + evt.duration_ns() / 1e3
            kernels.append((evt.linked_correlation_id(), evt.duration_ns()))
        elif evt.linked_correlation_id() == 0:
            op_start[evt.correlation_id()] = (evt.start_thread_id(), evt.start_ns())
            if name in SPANS:
                spans[name]["calls"] += 1
                ranges[name].setdefault(evt.start_thread_id(), []).append(
                    (evt.start_ns(), evt.end_ns()))
    for name, by_thread in ranges.items():
        for r in by_thread.values():
            r.sort()
        starts = {tid: [a for a, _ in r] for tid, r in by_thread.items()}
        ns = 0
        for op, dur in kernels:
            tid, t0 = op_start.get(op, (None, 0))
            if tid in by_thread:
                i = bisect.bisect_right(starts[tid], t0) - 1
                if i >= 0 and t0 <= by_thread[tid][i][1]:
                    ns += dur
        spans[name]["kernels_ms"] = ns / 1e6
    return kernel_us, len(kernels), spans


def check_device_events(prof, device_ms: float, kernels: int, spans, phase: str) -> None:
    """Hold ``device_events`` to ``key_averages()`` on a profile small
    enough for the latter (one decode tick): the same kernels, and the same
    device time in all and in each span within 0.1 %."""
    cuda = torch.autograd.DeviceType.CUDA
    avg_ms, avg_kernels = 0.0, 0
    avg_spans = {name: 0.0 for name in SPANS}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == cuda:
            if evt.key not in SPANS:
                avg_ms += float(getattr(evt, "self_device_time_total", 0.0) or 0.0) / 1e3
                avg_kernels += evt.count
        elif evt.key in SPANS:
            avg_spans[evt.key] += float(getattr(evt, "device_time_total", 0.0) or 0.0) / 1e3
    got = {"device_ms": device_ms, **{k: v["kernels_ms"] for k, v in spans.items()}}
    want = {"device_ms": avg_ms, **avg_spans}
    ok = kernels == avg_kernels and all(
        abs(got[k] - want[k]) <= 1e-3 * max(want[k], 1e-3) for k in want)
    emit({"phase": phase + "_events_vs_key_averages", "kernels": [kernels, avg_kernels],
          "device_events": got, "key_averages": want, "ok": ok})
    if not ok:
        raise SystemExit(f"{phase}: the raw-event device times disagree "
                         "with key_averages()")


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
    kernel_us, kernels, spans = device_events(prof)
    total_ms = sum(kernel_us.values()) / 1e3
    # The device time by part of the model: attention (after ln1), the MoE
    # FFN's routing and dispatch, its expert products, and the rest (norms,
    # dense MLPs, recurrences, embedding, head, sampling).
    moe_ms, experts_ms = spans["moe_ffn"]["kernels_ms"], spans["moe_experts"]["kernels_ms"]
    split = {"attention_ms": spans["attention"]["kernels_ms"],
             "moe_routing_dispatch_ms": moe_ms - experts_ms,
             "moe_expert_products_ms": experts_ms,
             "rest_ms": total_ms - spans["attention"]["kernels_ms"] - moe_ms}

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
        us, n, one_spans = device_events(one)
        alone[f"{name}_device_ms"] = sum(us.values()) / 1e3
        alone[f"{name}_kernels"] = n
        if name == "decode_tick":
            check_device_events(one, sum(us.values()) / 1e3, n, one_spans, phase)
    emit({"phase": phase, "arch": cfg.name, "profiled_wall_s": wall_s,
          "kernel_device_ms": total_ms, "kernels": kernels,
          "device_busy_share_profiled": total_ms / 1e3 / wall_s,
          "device_busy_share_of_serve_wall": total_ms / 1e3 / serve_wall_s,
          "rmsnorm_kernel_ms": share("rmsnorm_kernel"),
          "flash_kernel_ms": share("flash_kernel"),
          "rglru_kernel_ms": share("rglru_kernel"),
          "device_ms_by_part": split, "spans": spans,
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
    D, per_pass, bf16 = cfg.d_model, pass_norms(cfg), torch.bfloat16
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


# ---------------------------------------------------------------------------
# Training: backward checks, the trainer, full-width train steps
# ---------------------------------------------------------------------------


def check_rmsnorm_backward() -> float:
    """The RMS-norm backward kernel against its plain version: dx within the
    forward's tolerance; dscale, a sum over N rows, within 1e-6 of the
    column's sum of |g * x * r| (float32 sums taken in another order), plus
    one bfloat16 spacing (2^-7 of the value) where dscale is bfloat16.
    Two calls on the same inputs give the same bits (no atomics)."""
    gen = torch.Generator("cuda").manual_seed(5)
    worst = 0.0
    for xdt, sdt in RMS_DTYPES:
        for n, d in RMS_BWD_SHAPES:
            x = torch.randn((n, d), generator=gen, device="cuda").to(xdt)
            g = torch.randn((n, d), generator=gen, device="cuda").to(xdt)
            scale = (0.2 * torch.randn((d,), generator=gen, device="cuda")).to(sdt)
            dx, ds = rms_kernel.rms_norm_bwd_cuda(x, scale, g)
            again = rms_kernel.rms_norm_bwd_cuda(x, scale, g)
            want_dx, want_ds = rms_norm_backward_reference(x, scale, g)
            xf = x.float()
            r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
            l1 = (g.float() * xf * r).abs().sum(0)
            spacing = 2.0 ** -7 if sdt == torch.bfloat16 else 0.0
            ds_err = (ds.float() - want_ds.float()).abs()
            ds_ok = bool((ds_err <= 1e-6 * l1 + spacing * want_ds.float().abs()).all())
            err = float((dx.float() - want_dx.float()).abs().max())
            same = torch.equal(dx, again[0]) and torch.equal(ds, again[1])
            ok = (dx.dtype == xdt and ds.dtype == sdt and err <= RMS_TOL[xdt]
                  and ds_ok and same)
            emit({"phase": "rmsnorm_backward_vs_plain", "shape": [n, d],
                  "x_dtype": str(xdt), "scale_dtype": str(sdt),
                  "dx_max_abs_err": err, "dx_tol": RMS_TOL[xdt],
                  "dscale_max_abs_err": float(ds_err.max()),
                  "dscale_max_err_over_l1": float((ds_err / l1.clamp(min=1e-30)).max()),
                  "dscale_ok": ds_ok, "repeat_bit_equal": same,
                  "plan": rms_kernel.backward_plan(d, xdt)._asdict(),
                  "blocks": rms_kernel.backward_blocks(n, rms_kernel.backward_plan(d, xdt)),
                  "ok": ok})
            if not ok:
                raise SystemExit(f"rmsnorm backward differs at {n}x{d} {xdt}/{sdt}")
            worst = max(worst, err)
    return worst


def check_rglru_backward() -> float:
    """The RG-LRU backward kernel bit-equal to the flip construction over
    ``rglru_scan_chunked`` at the plan's chunk length (what the card ran
    before the kernel), and within ``RGLRU_TOL`` (1e-5 in f32) of the
    explicit reverse loop, over ``RGLRU_BWD_S`` x W x B x h0 x dtype."""
    gen = torch.Generator("cuda").manual_seed(6)
    worst = 0.0
    for dtype, s, w, bsz, with_h0 in itertools.product(
            (torch.float32, torch.bfloat16), RGLRU_BWD_S, RGLRU_BWD_W, RGLRU_BWD_B,
            (False, True)):
        shape = (bsz, s, w)
        a = (0.5 + 0.499 * torch.rand(shape, generator=gen, device="cuda")).to(dtype)
        b = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        h0 = (torch.randn((bsz, w), generator=gen, device="cuda").to(dtype)
              if with_h0 else None)
        h, _last = rglru_kernel.rglru_scan_cuda(a, b, h0)
        gh = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g_last = torch.randn((bsz, w), generator=gen, device="cuda")
        got = rglru_kernel.rglru_scan_backward_cuda(a, h, h0, gh, g_last)
        length = rglru_kernel.chunk_plan(s, w).length
        chunked = rglru_scan_backward(
            a, h, h0, gh, g_last,
            lambda a_, b_, h0_: rglru_scan_chunked(a_, b_, h0_, length))
        loop = rglru_scan_backward_reference(a, h, h0, gh, g_last)
        pairs = [(x, y, z) for x, y, z in zip(got, chunked, loop) if x is not None]
        bit = all(x.dtype == y.dtype and torch.equal(bits(x), bits(y))
                  for x, y, _ in pairs)
        err = max(float((x.float() - z.float()).abs().max()) for x, _, z in pairs)
        ok = bit and err <= RGLRU_TOL[dtype]
        emit({"phase": "rglru_backward_vs_plain", "shape": list(shape), "h0": with_h0,
              "dtype": str(dtype), "chunk_len": length, "bit_equal_chunked": bit,
              "max_abs_err_vs_loop": err, "tol": RGLRU_TOL[dtype], "ok": ok})
        if not ok:
            raise SystemExit(f"rglru backward differs at {shape} h0={with_h0} {dtype}")
        worst = max(worst, err)
    return worst


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers, so that equality tells -0 from 0."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def flash_backward_inputs(b, h, kv, sq, skv, d, causal, window, dtype, gen):
    """q, k, v in the model's layout, the forward kernel's out and lse, and
    a random incoming gradient."""
    q, k, v = flash_inputs(b, h, kv, sq, skv, d, dtype, gen, True)
    lse = torch.empty((b, h, sq), device="cuda")
    out = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, window=window, lse=lse)
    d_out = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    return q, k, v, out, d_out, lse


def gradient_errors(got, want) -> list[float]:
    """max |got - want| / max(1, |want|) of each of dq, dk, dv."""
    return [float(((g.float() - w.float()).abs() / w.float().abs().clamp(min=1.0)).max())
            for g, w in zip(got, want)]


def check_flash_backward_kernel() -> float:
    """The backward kernel alone against its plain version
    (``flash_backward_reference``: P from the same lse) and against the
    explicit gradient in float32 from the same inputs, both dtypes, every
    case twice: the two runs must give the same bits.  The forward
    kernel's lse is held against ``attention_lse_reference``."""
    gen = torch.Generator("cuda").manual_seed(11)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        variant = flash_kernel.VARIANTS[dtype]
        for b, h, kv, sq, skv, d, causal, window in FLASH_BWD_KERNEL:
            q, k, v, out, d_out, lse = flash_backward_inputs(
                b, h, kv, sq, skv, d, causal, window, dtype, gen)
            before = dict(flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT)
            got = flash_kernel.flash_attention_backward_cuda(
                q, k, v, out, d_out, lse, causal=causal, window=window)
            again = flash_kernel.flash_attention_backward_cuda(
                q, k, v, out, d_out, lse, causal=causal, window=window)
            torch.cuda.synchronize()
            ran = {x: n - before[x] for x, n in flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT.items()}
            plain = flash_backward_reference(q, k, v, out, d_out, lse, causal=causal,
                                             window=window)
            oracle = attention_backward_reference(
                *(t.float() for t in (q, k, v, out, d_out)), causal=causal, window=window)
            lse_want = attention_lse_reference(q, k, causal=causal, window=window)
            err_plain, err_oracle = gradient_errors(got, plain), gradient_errors(got, oracle)
            lse_err = float((lse - lse_want).abs().max())
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            ok = (same and max(err_plain + err_oracle) <= FLASH_BWD_TOL[dtype]
                  and all(g.dtype == dtype and g.shape == t.shape
                          and bool(torch.isfinite(g).all()) for g, t in zip(got, (q, k, v)))
                  and lse_err <= FLASH_LSE_TOL
                  and ran == {x: 2 * (x == variant) for x in ran})
            emit({"phase": "flash_backward_kernel_vs_plain",
                  "shape": [b, h, kv, sq, skv, d], "causal": causal, "window": window,
                  "dtype": str(dtype), "split": flash_kernel.backward_split(
                      flash_kernel.backward_keys_per_block(variant, d), b, kv, h // kv, skv),
                  "max_err_dq_dk_dv_vs_plain": err_plain,
                  "max_err_dq_dk_dv_vs_explicit_f32": err_oracle,
                  "tol_times_max_1_abs": FLASH_BWD_TOL[dtype], "lse_max_abs_err": lse_err,
                  "lse_tol": FLASH_LSE_TOL, "repeat_bit_equal": same,
                  "backward_launches_by_variant": ran, "ok": ok})
            if not ok:
                raise SystemExit(f"flash backward kernel differs at "
                                 f"{(b, h, kv, sq, skv, d, causal, window)} {dtype}")
            worst = max(worst, *err_plain, *err_oracle)
            del q, k, v, out, d_out, lse, got, again, plain, oracle
    torch.cuda.empty_cache()
    return worst


def check_flash_backward() -> float:
    """The flash Function's gradients (the forward and backward kernels)
    against autograd of the plain forward, in the model's layout; one
    backward launch a case, through the dtype's variant."""
    gen = torch.Generator("cuda").manual_seed(7)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, kv, s, d, window in FLASH_BWD:
            before = dict(flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT)
            q, k, v = (t.requires_grad_() for t in
                       flash_inputs(b, h, kv, s, s, d, dtype, gen, True))
            d_out = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
            got = torch.autograd.grad(
                flash_ops.FlashAttentionFunction.apply(q, k, v, True, window),
                (q, k, v), d_out)
            want = torch.autograd.grad(flash_plain(q, k, v, True, window),
                                       (q, k, v), d_out)
            errs = [float(((g.float() - w.float()).abs()
                           / w.float().abs().clamp(min=1.0)).max())
                    for g, w in zip(got, want)]
            ran = {v: n - before[v]
                   for v, n in flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT.items()}
            launched = ran == {v: int(v == flash_kernel.VARIANTS[dtype]) for v in ran}
            ok = (all(g.dtype == dtype and bool(torch.isfinite(g).all()) for g in got)
                  and max(errs) <= FLASH_BWD_TOL[dtype] and launched)
            emit({"phase": "flash_backward_vs_plain", "shape": [b, h, kv, s, s, d],
                  "window": window, "dtype": str(dtype),
                  "max_err_dq_dk_dv": errs, "tol_times_max_1_abs": FLASH_BWD_TOL[dtype],
                  "backward_launches_by_variant": ran, "ok": ok})
            if not ok:
                raise SystemExit(f"flash backward differs at {(b, h, kv, s, d)} {dtype}")
            worst = max(worst, *errs)
    return worst


# Calls of the explicit flash gradient on CUDA tensors: no training path
# may make one (every one goes through the backward kernel).  chip_smoke's
# own checks call the function it imported, not the module's attribute.
EXPLICIT_FLASH_GRADIENT = {"on_cuda": 0}


def watch_explicit_flash_gradient() -> None:
    """Count every call of ``ref.attention_backward_reference`` made through
    the module on CUDA tensors from here on."""
    plain = flash_ref.attention_backward_reference

    def counted(q, *args, **kwargs):
        EXPLICIT_FLASH_GRADIENT["on_cuda"] += q.is_cuda
        return plain(q, *args, **kwargs)

    flash_ref.attention_backward_reference = counted


def current_launches() -> dict[str, int]:
    return {**{name: module.LAUNCHES for name, module in KERNELS.items()},
            "rmsnorm_backward": rms_kernel.BACKWARD_LAUNCHES,
            "rglru_backward": rglru_kernel.BACKWARD_LAUNCHES,
            "flash_backward": flash_kernel.BACKWARD_LAUNCHES,
            "explicit_flash_gradient_on_cuda": EXPLICIT_FLASH_GRADIENT["on_cuda"]}


def train_trainer() -> None:
    """The Trainer on the card (recurrentgemma-2b smoke, float32) under
    deterministic algorithms, with a crash after the step-3 checkpoint:
    the replayed steps' losses must be bit-identical, and every step's loss
    and grad norm within 1e-4 of the port's CPU run from the same step-0
    checkpoint; on the card every step's update goes through the AdamW
    kernel, one launch a leaf."""
    cfg = dataclasses.replace(get_config(RG).smoke(), compute_dtype="float32")
    shape = ShapeConfig("trainer_check", seq_len=TRAINER_SEQ,
                        global_batch=TRAINER_BATCH, kind="train")
    kw = dict(num_steps=TRAINER_STEPS, checkpoint_every=TRAINER_CKPT_EVERY,
              warmup_steps=2)
    with tempfile.TemporaryDirectory() as d:
        start, card_dir, cpu_dir = (os.path.join(d, n) for n in ("start", "card", "cpu"))
        torch.use_deterministic_algorithms(True)
        try:
            Trainer(cfg, shape, TrainerConfig(num_steps=0, checkpoint_dir=start),
                    device="cuda").run()
            shutil.copytree(start, card_dir)
            shutil.copytree(start, cpu_dir)
            reset_launches()
            adamw_before = adamw_kernel.LAUNCHES
            t0 = time.perf_counter()
            card = Trainer(cfg, shape, TrainerConfig(checkpoint_dir=card_dir, **kw),
                           failure_plan=FailurePlan(
                               [FailureEvent(step=TRAINER_CRASH_AT, kind="crash")]),
                           device="cuda")
            out = card.run()
            card_s = time.perf_counter() - t0
            launches = current_launches()
            adamw_launches = adamw_kernel.LAUNCHES - adamw_before
        finally:
            torch.use_deterministic_algorithms(False)
        t0 = time.perf_counter()
        cpu = Trainer(cfg, shape, TrainerConfig(checkpoint_dir=cpu_dir, **kw),
                      device="cpu")
        cpu.run()
        cpu_s = time.perf_counter() - t0
    seen: dict[int, float] = {}
    replay = []
    for m in card.metrics_history:
        if m["step"] in seen:
            replay.append(abs(seen[m["step"]] - m["loss"]))
        seen[m["step"]] = m["loss"]
    on_cpu = {m["step"]: m for m in cpu.metrics_history}
    deltas = {k: max(abs(m[k] - on_cpu[m["step"]][k]) for m in card.metrics_history)
              for k in ("loss", "grad_norm")}
    ok = (out["restarts"] == 1 and bool(replay) and max(replay) == 0.0
          and max(deltas.values()) <= TRAINER_TOL
          and all(launches[k] > 0 for k in ("rmsnorm", "rmsnorm_backward", "flash",
                                             "flash_backward", "rglru", "rglru_backward"))
          and launches["explicit_flash_gradient_on_cuda"] == 0
          and adamw_launches > 0 and adamw_launches % len(adamw.tree_leaves(
              lm.lm_param_specs(cfg))) == 0
          and flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT["wgmma"] == 0
          and all(math.isfinite(m["loss"]) for m in card.metrics_history))
    emit({"phase": "train_trainer", "arch": cfg.name, "compute_dtype": cfg.compute_dtype,
          "deterministic_algorithms": True,
          "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
          "shape": [TRAINER_BATCH, TRAINER_SEQ], "steps": TRAINER_STEPS,
          "crash_at": TRAINER_CRASH_AT, "restarts": out["restarts"],
          "replayed_steps": len(replay),
          "replay_max_delta": max(replay) if replay else None,
          "card_losses": [[m["step"], m["loss"]] for m in card.metrics_history],
          "max_delta_vs_cpu": deltas, "tol": TRAINER_TOL,
          "card_wall_s": card_s, "cpu_wall_s": cpu_s,
          "launches": launches, "adamw_launches": adamw_launches, "ok": ok})
    if not ok:
        raise SystemExit("trainer on the card: replay or CPU parity failed")


@contextlib.contextmanager
def plain_adamw():
    """``adamw.apply_updates`` with every leaf through the plain loop, on
    the card too."""
    saved = adamw.adamw_update
    adamw.adamw_update = adamw_ref.adamw_update_reference
    try:
        yield
    finally:
        adamw.adamw_update = saved


def adamw_leaf(shape, dtype, gen, scale: float | None, offset: int) -> torch.Tensor:
    """A leaf of normal values times ``scale`` (zeros for None), ``offset``
    elements into its allocation."""
    n = math.prod(shape)
    if scale is None:
        buf = torch.zeros(n + offset, dtype=dtype, device="cuda")
    else:
        buf = torch.randn(n + offset, generator=gen, device="cuda").mul_(scale).to(dtype)
    return buf[offset:].view(shape)


def adamw_case(shape, param_dtype, state_dtype: str, clip: float, offset: int,
               gen) -> bool:
    """Two AdamW steps of one leaf through ``apply_updates`` (one kernel
    launch each) and through the plain loop, from the same values: are p, m
    and v bit-equal after them?"""
    cfg = adamw.AdamWConfig(clip_norm=clip, state_dtype=state_dtype)
    sdt = getattr(torch, state_dtype)
    params = {"w": adamw_leaf(shape, param_dtype, gen, 1.0, offset)}
    state = {"m": {"w": adamw_leaf(shape, sdt, gen, None, offset)},
             "v": {"w": adamw_leaf(shape, sdt, gen, None, offset)},
             "count": torch.zeros((), dtype=torch.int32, device="cuda")}
    plain = adamw.tree_map(torch.clone, params)
    plain_state = {k: adamw.tree_map(torch.clone, v) for k, v in state.items()}
    lr = torch.tensor(3e-4, device="cuda")
    for step in range(2):
        grads = {"w": adamw_leaf(shape, param_dtype, gen, 10.0 ** (step - 1), offset)}
        before = adamw_kernel.LAUNCHES
        adamw.apply_updates(params, grads, state, cfg, lr)
        if adamw_kernel.LAUNCHES != before + 1:
            raise SystemExit(f"adamw {shape}: {adamw_kernel.LAUNCHES - before} launches "
                             f"for one leaf")
        with plain_adamw():
            adamw.apply_updates(plain, grads, plain_state, cfg, lr)
    return all(torch.equal(bits(a), bits(b)) for a, b in (
        (params["w"], plain["w"]), (state["m"]["w"], plain_state["m"]["w"]),
        (state["v"]["w"], plain_state["v"]["w"])))


def check_adamw() -> dict:
    """The AdamW kernel bit for bit against the plain loop (ADAMW_* cases),
    then timed on the benchmark's training tree: the whole of
    ``apply_updates`` (the clipping norm and one launch a leaf), the
    kernel's launches alone against the bound of their bytes, the plain
    loop's ``apply_updates``, and ``torch._fused_adamw_`` on the same leaves
    (the yardstick only: decoupled weight decay, no clipping, other
    arithmetic on the same bytes).  Returns the ``kernels`` row."""
    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    shapes = sorted({s.shape for s in adamw.tree_leaves(lm.lm_param_specs(cut(OLMOE, 1)))})
    cases = [(shape, pdt, sdt, 1.0, 0) for pdt, sdt in ADAMW_DTYPES for shape in shapes]
    cases += [((n,), pdt, sdt, clip, offset) for pdt, sdt in ADAMW_DTYPES
              for n in ADAMW_ODD_SIZES for clip in ADAMW_CLIPS for offset in (0, 1)]
    t0 = time.perf_counter()
    unequal = [str(c[:5]) for c in cases if not adamw_case(*c, gen)]
    check_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    cfg = adamw.AdamWConfig()
    params = init_params(lm.lm_param_specs(cut(OLMOE, ADAMW_PATH_LAYERS)), 0, "cuda",
                         torch.float32)
    grads = adamw.tree_map(lambda p: torch.randn(p.shape, generator=gen, device="cuda"),
                           params)
    state = adamw.init_state(params, cfg)
    lr = torch.tensor(3e-4, device="cuda")
    leaves = [adamw.tree_leaves(t) for t in (params, grads, state["m"], state["v"])]
    n, n_leaves = sum(p.numel() for p in leaves[0]), len(leaves[0])
    bound_ms = ADAMW_BYTES * n / HBM_BYTES_PER_S * 1e3

    def path():
        adamw.apply_updates(params, grads, state, cfg, lr)

    scale = torch.ones((), device="cuda")
    b1c, b2c = (torch.tensor(1 - b ** 3, dtype=torch.float32, device="cuda")
                for b in (cfg.b1, cfg.b2))

    def update():
        for p, g, m, v in zip(*leaves):
            adamw.adamw_update(p, g, m, v, scale, b1c, b2c, lr, cfg.b1, cfg.b2, cfg.eps,
                               cfg.weight_decay)

    steps_t = [torch.ones((), device="cuda") for _ in leaves[0]]

    def library():
        torch._fused_adamw_(*leaves, [], steps_t, lr=3e-4, beta1=cfg.b1, beta2=cfg.b2,
                            weight_decay=cfg.weight_decay, eps=cfg.eps, amsgrad=False,
                            maximize=False)

    path()
    update()
    before = adamw_kernel.LAUNCHES
    path_ms = event_ms(path, ADAMW_REPS)
    launches = (adamw_kernel.LAUNCHES - before) / ADAMW_REPS
    update_ms = event_ms(update, ADAMW_REPS)
    with plain_adamw():
        path()
        plain_ms = event_ms(path, ADAMW_REPS)
    library()
    library_ms = event_ms(library, ADAMW_REPS)
    ms = statistics.median(update_ms)
    emit({"phase": "adamw", "cases": len(cases), "unequal": unequal, "check_s": check_s,
          "path": f"{OLMOE} at {ADAMW_PATH_LAYERS} layers, f32 parameters and state",
          "leaves": n_leaves, "params": n, "launches_per_step": launches,
          "path_ms": path_ms, "update_ms": update_ms, "bound_ms": bound_ms,
          "share_of_bound": bound_ms / ms, "update_gb_per_s": ADAMW_BYTES * n / ms / 1e6,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del params, grads, state, leaves
    torch.cuda.empty_cache()
    if unequal or launches != n_leaves:
        raise SystemExit(f"adamw: cases not bit-equal to the plain loop {unequal[:5]}, "
                         f"or {launches} launches a step")
    return {"name": "adamw", "route": "cuda",
            "source": "src/repro_torch/kernels/adamw/csrc/adamw.cu",
            "replaces": None, "launches": launches, "max_abs_err": 0.0, "ms": ms,
            "path_ms": statistics.median(path_ms),
            "plain_ms": statistics.median(plain_ms), "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": statistics.median(library_ms)}


def expected_train_launches(cfg) -> dict[str, int]:
    """Per train step with every block recomputed in the backward: each
    block's norms twice and final_norm once forward, each once backward;
    one flash launch per attention-kind layer, twice, and one launch of the
    flash backward kernel; one RG-LRU scan per rec layer, twice (forward
    and recompute), and one launch of the RG-LRU backward kernel, which
    runs no forward scan; no call of the explicit flash gradient
    on the card.  An encoder-decoder counts its encoder's blocks (two
    norms, one non-causal flash launch), its decoder's (three norms, a
    causal and a cross flash launch) and two final norms."""
    if not cfg.remat:
        raise SystemExit(f"{cfg.name}: the expected counts assume remat")
    if cfg.encoder_layers:
        blocks, finals = 2 * cfg.encoder_layers + 3 * cfg.num_layers, 2
        flash, rec = cfg.encoder_layers + 2 * cfg.num_layers, 0
    else:
        blocks, finals = pass_norms(cfg) - 1, 1
        flash, rec = attention_layers(cfg), cfg.layer_counts().get("rec", 0)
    return {"mandelbrot": 0, "rmsnorm": 2 * blocks + finals, "flash": 2 * flash,
            "rglru": 2 * rec, "rmsnorm_backward": blocks + finals,
            "rglru_backward": rec, "flash_backward": flash,
            "explicit_flash_gradient_on_cuda": 0}


def train_full() -> dict:
    """``make_train_step`` at recurrentgemma-2b's full width and depth:
    bf16 compute, f32 parameters and AdamW state, fresh SyntheticLM batches.
    A first step warms up (its loss is printed: ln V at init); the next
    steps are timed, their kernel launches counted step by step, and one
    more runs under torch.profiler."""
    cfg = get_config(RG)
    specs = lm.lm_param_specs(cfg)
    t0 = time.perf_counter()
    params = init_params(specs, 0, "cuda", torch.float32)
    opt_cfg = adamw.AdamWConfig()
    opt_state = adamw.init_state(params, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, peak_lr=3e-4, warmup_steps=2,
                                        total_steps=TRAIN_STEPS + 2)
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0),
                        "cuda")
    t0 = time.perf_counter()
    params, opt_state, m = step_fn(params, opt_state, pipe.get(0), 0)
    first_loss = float(m["loss"])
    first_ms = (time.perf_counter() - t0) * 1e3
    expected = expected_train_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for step in range(1, TRAIN_STEPS + 1):
        batch = pipe.get(step)
        before, adamw_before = current_launches(), adamw_kernel.LAUNCHES
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch, step)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = current_launches()
        rows.append({"step": step, "loss": loss, "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]), "ms": ms,
                     "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                     "launches": {k: after[k] - before[k] for k in after},
                     "adamw_launches": adamw_kernel.LAUNCHES - adamw_before})
    launches = current_launches()
    flash_variants = dict(flash_kernel.LAUNCHES_BY_VARIANT)
    backward_variants = dict(flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # One more step under the profiler: device time and where it goes.
    from torch.profiler import ProfilerActivity, profile

    batch = pipe.get(TRAIN_STEPS + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, opt_state, m = step_fn(params, opt_state, batch, TRAIN_STEPS + 1)
        float(m["loss"])
        torch.cuda.synchronize()
    kernel_us, kernels, _spans = device_events(prof)
    device_ms = sum(kernel_us.values()) / 1e3
    mean_ms = statistics.mean(r["ms"] for r in rows)
    emit({"phase": "train_full", "arch": cfg.name, "num_layers": cfg.num_layers,
          "layer_kinds": cfg.layer_counts(), "d_model": cfg.d_model,
          "params": count_params(specs), "param_dtype": cfg.param_dtype,
          "compute_dtype": cfg.compute_dtype, "state_dtype": opt_cfg.state_dtype,
          "remat": cfg.remat, "loss_seq_chunk": cfg.loss_seq_chunk,
          "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
          "reduced_from": {"shape": TRAIN_4K.name,
                           "seq_len": [TRAIN_4K.seq_len, TRAIN_SEQ],
                           "global_batch": [TRAIN_4K.global_batch, TRAIN_BATCH]},
          "init_params_s": init_s, "first_step_loss": first_loss,
          "ln_vocab": math.log(cfg.vocab_size), "first_step_ms": first_ms,
          "steps": rows, "mean_step_ms": mean_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3,
          "peak_memory_gb": peak_gb, "expected_launches_per_step": expected,
          "flash_launches_by_variant": flash_variants,
          "flash_backward_launches_by_variant": backward_variants,
          "profiled_step_device_ms": device_ms, "profiled_step_kernels": kernels,
          "top_kernels": [[k[:80], us / 1e3] for k, us in sorted(
              kernel_us.items(), key=lambda kv: -kv[1])[:12]]})
    losses = [first_loss] + [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"full-width training: a loss is not finite: {losses}")
    if abs(first_loss - math.log(cfg.vocab_size)) > 2.0:
        raise SystemExit(f"full-width training: first loss {first_loss} is far from ln V")
    leaves = len(adamw.tree_leaves(params))
    for r in rows:
        if r["launches"] != expected or r["adamw_launches"] != leaves:
            raise SystemExit(f"train step {r['step']}: launches {r['launches']} != "
                             f"expected {expected}, or {r['adamw_launches']} AdamW "
                             f"launches for {leaves} leaves")
    if (flash_variants != {"wgmma": expected["flash"] * TRAIN_STEPS, "f32": 0}
            or backward_variants != {"wgmma": expected["flash_backward"] * TRAIN_STEPS,
                                     "f32": 0}):
        raise SystemExit(f"bf16 training ran flash launches {flash_variants}, "
                         f"backward {backward_variants}")
    train = {"cfg": cfg, "launches": launches, "mean_step_ms": mean_ms,
             "device_ms": device_ms, "first_loss": first_loss, "steps": rows,
             "peak_memory_gb": peak_gb, "gemm_ms": gemm_ms(kernel_us)}
    train_full_dots(train, params, opt_state, pipe, expected)
    del params, opt_state
    torch.cuda.empty_cache()
    return train


def gemm_ms(kernel_us: dict[str, float]) -> float:
    """The device ms of a profile's cuBLAS products (by kernel name)."""
    return sum(us for name, us in kernel_us.items()
               if any(w in name for w in GEMM_NAMES)) / 1e3


def train_full_dots(train: dict, params, opt_state, pipe, expected: dict) -> None:
    """``train_full``'s step under ``remat_policy="dots"``, from its
    parameters, optimizer state and batches.  Under deterministic
    algorithms, one forward and backward under each policy: the loss's and
    every gradient's bits must be equal, and each pass's launches the
    expected ones (every kernel is still recomputed; only the recompute's
    weight products are saved instead).  Then DOTS_STEPS timed steps under
    "dots", their launches checked step by step and their peak memory from
    a reset before them, and one more under the profiler."""
    cfg = dataclasses.replace(train["cfg"], remat_policy="dots")
    batch = pipe.get(TRAIN_STEPS + 2)
    prints, passes = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for c in (train["cfg"], cfg):
            reset_launches()
            prints[c.remat_policy] = grad_fingerprint(c, params, batch)
            passes[c.remat_policy] = current_launches()
    finally:
        torch.use_deterministic_algorithms(False)
    same = prints["nothing"] == prints["dots"]
    step_fn = steps_mod.make_train_step(cfg, adamw.AdamWConfig(), peak_lr=3e-4,
                                        warmup_steps=2,
                                        total_steps=TRAIN_STEPS + DOTS_STEPS + 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for step in range(TRAIN_STEPS + 3, TRAIN_STEPS + 3 + DOTS_STEPS):
        batch = pipe.get(step)
        before = current_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch, step)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = current_launches()
        rows.append({"step": step, "loss": loss, "grad_norm": float(m["grad_norm"]),
                     "ms": ms, "launches": {k: after[k] - before[k] for k in after}})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    from torch.profiler import ProfilerActivity, profile

    batch = pipe.get(TRAIN_STEPS + 3 + DOTS_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, opt_state, m = step_fn(params, opt_state, batch,
                                       TRAIN_STEPS + 3 + DOTS_STEPS)
        float(m["loss"])
        torch.cuda.synchronize()
    kernel_us, kernels, _spans = device_events(prof)
    device_ms = sum(kernel_us.values()) / 1e3
    mean_ms = statistics.mean(r["ms"] for r in rows)
    emit({"phase": "train_full_dots", "arch": cfg.name, "remat_policy": cfg.remat_policy,
          "deterministic_algorithms_for_the_bits": True,
          "loss_bits_equal": prints["nothing"][0] == prints["dots"][0],
          "gradient_checksums_equal": prints["nothing"][1] == prints["dots"][1],
          "leaves": len(prints["dots"][1]), "launches_per_pass": passes,
          "steps": rows, "mean_step_ms": mean_ms,
          "nothing_mean_step_ms": train["mean_step_ms"],
          "peak_memory_gb": peak_gb, "nothing_peak_memory_gb": train["peak_memory_gb"],
          "profiled_step_device_ms": device_ms,
          "nothing_profiled_step_device_ms": train["device_ms"],
          "profiled_step_kernels": kernels,
          "gemm_device_ms": gemm_ms(kernel_us), "nothing_gemm_device_ms": train["gemm_ms"],
          "expected_launches_per_step": expected, "ok": same})
    if not same:
        raise SystemExit("train_full_dots: the loss or a gradient differs between "
                         "remat policies")
    for policy, got in passes.items():
        if got != expected:
            raise SystemExit(f"train_full_dots: a {policy} pass launched {got} != "
                             f"expected {expected}")
    for r in rows:
        if r["launches"] != expected or not math.isfinite(r["loss"]):
            raise SystemExit(f"train_full_dots step {r['step']}: {r}")


def rms_backward_library(x, scale, g):
    """PyTorch's one call for the RMS-norm gradient on the kernel's inputs:
    ``aten._fused_rms_norm_backward`` with weight = 1 + scale in x's type
    and the rstd of ``aten._fused_rms_norm``, taken once, outside the
    timing."""
    D = x.shape[1]
    weight = (1.0 + scale.float()).to(x.dtype)
    _out, rstd = torch.ops.aten._fused_rms_norm(x, [D], weight, 1e-6)
    return lambda: torch.ops.aten._fused_rms_norm_backward(g, x, [D], rstd, weight,
                                                           [True, True])


def profiled_launch_ms(calls) -> dict[str, float]:
    """Device ms per call of each kernel that ``calls`` launch, by the
    kernel's name (its template arguments kept, its parameters dropped),
    from the profiler's raw events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for name, us in device_events(prof)[0].items():
        short = name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]
        out[short] = out.get(short, 0.0) + us / 1e3 / len(calls)
    return out


def train_kernel_rows(train: dict, errs: dict, clock_hz: float) -> list[dict]:
    """The backward kernels at the training path's shapes, launch for
    launch over the timed steps, beside their plain versions; the flash
    backward also beside SDPA's backward on the same inputs and the forward
    kernel."""
    cfg = train["cfg"]
    gen = torch.Generator("cuda").manual_seed(8)
    N, D, W = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, cfg.rnn_width or cfg.d_model
    bf16 = torch.bfloat16
    rows = []

    x = torch.randn((N, D), generator=gen, device="cuda").to(bf16)
    g = torch.randn((N, D), generator=gen, device="cuda").to(bf16)
    scale = 0.2 * torch.randn((D,), generator=gen, device="cuda")
    n = train["launches"]["rmsnorm_backward"]
    rms_bytes = (3 * N * D * 2 + 2 * D * 4) * n
    rms_ops = 12 * N * D * n  # squares, dot, gs, dx and dscale terms, f32
    a, gates_b = model_gates(TRAIN_BATCH, TRAIN_SEQ, W, gen)
    h, _last = rglru_kernel.rglru_scan_cuda(a, gates_b)
    gh = torch.randn_like(h)
    g_last = torch.zeros((TRAIN_BATCH, W), device="cuda")
    k_rg = train["launches"]["rglru_backward"]
    rg_bytes = 5 * TRAIN_BATCH * TRAIN_SEQ * W * 4 * k_rg  # a, h, gh in; da, db out
    rg_ops = 4 * TRAIN_BATCH * TRAIN_SEQ * W * k_rg
    # The RMS-norm gradient has one PyTorch call; the RG-LRU's has none.
    rms_library = rms_backward_library(x, scale, g)
    for name, src, replaces, calls, plain, library, nbytes, ops, err in (
        ("rmsnorm_backward", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu",
         "src/repro/kernels/rmsnorm/kernel.py:21",
         [lambda: rms_kernel.rms_norm_bwd_cuda(x, scale, g)] * n,
         [lambda: rms_norm_backward_reference(x, scale, g)] * n,
         [rms_library] * n, rms_bytes, rms_ops, errs["rmsnorm_backward"]),
        ("rglru_scan_backward", "src/repro_torch/kernels/rglru/csrc/rglru_bwd.cu",
         "src/repro/kernels/rglru/kernel.py:32",
         [lambda: rglru_kernel.rglru_scan_backward_cuda(a, h, None, gh, g_last)] * k_rg,
         [lambda: rglru_scan_backward_reference(a, h, None, gh, g_last)] * k_rg,
         None, rg_bytes, rg_ops, errs["rglru_backward"]),
    ):
        calls[0](), plain[0]()  # warm-up
        if library:
            library[0]()
        torch.cuda.synchronize()
        ms, paced = spun_device_ms(calls, clock_hz)
        plain_ms, plain_paced = spun_device_ms(plain, clock_hz)
        lib_ms, lib_paced = spun_device_ms(library, clock_hz) if library else (None, False)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_FLOPS_PER_S * 1e3
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": len(calls), "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "library_ms": lib_ms,
               "host_paced": [k for k, p in (("ms", paced), ("plain_ms", plain_paced),
                                             ("library_ms", lib_paced)) if p]}
        extra = {}
        if library:
            # Where a call's time goes, launch by launch, the kernel's and
            # the library op's (its kernel names show whether it is fused).
            by_launch = profiled_launch_ms(calls)
            extra = {"library_op": "torch.ops.aten._fused_rms_norm_backward",
                     "share_of_bound": row["bound_ms"] / ms,
                     "ms_over_library": ms / lib_ms,
                     "plan": rms_kernel.backward_plan(D, x.dtype)._asdict(),
                     "blocks": rms_kernel.backward_blocks(N, rms_kernel.backward_plan(D, x.dtype)),
                     "profiled_ms_per_call_by_launch": by_launch,
                     "library_kernels_ms_per_call": profiled_launch_ms(library)}
        else:
            # The kernel's one launch a call, beside the construction it
            # replaced (the forward scan kernel on flipped inputs and the
            # PyTorch glue around it) on the same inputs, in this call.
            construction = [lambda: rglru_scan_backward(
                a, h, None, gh, g_last, rglru_kernel.rglru_scan_cuda)] * len(calls)
            construction[0]()
            torch.cuda.synchronize()
            construction_ms, construction_paced = spun_device_ms(construction, clock_hz)
            if construction_paced:
                row["host_paced"].append("construction_ms")
            extra = {"share_of_bound": row["bound_ms"] / ms,
                     "construction_ms": construction_ms,
                     "profiled_ms_per_call_by_launch": profiled_launch_ms(calls)}
            row.update(extra)
        emit({"phase": "kernel_time", "kernel": name, "arch": cfg.name,
              "path": "train_full", **{k: v for k, v in row.items()
                                       if k not in ("name", "source", "replaces")},
              **extra})
        rows.append(row)

    # Flash: the backward kernel at recurrentgemma-2b's shape, every call
    # of the timed steps, beside the explicit gradient (its plain version),
    # SDPA's backward on the same inputs and the forward kernel.
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n_fl = train["launches"]["flash_backward"]
    shape = (TRAIN_BATCH, H, KV, TRAIN_SEQ, TRAIN_SEQ, hd, True, cfg.window_size)
    work = flash_backward_work([shape] * n_fl, gen)
    times = {}
    for key, fns in (("backward_ms", work["ms"]), ("plain_ms", work["plain_ms"]),
                     ("library_backward_ms", work["library_ms"]),
                     ("forward_kernel_ms", work["forward_ms"])):
        fns[0]()
        torch.cuda.synchronize()
        times[key], _paced = spun_device_ms(fns, clock_hz)
    steps = n_fl // expected_train_launches(cfg)["flash_backward"]
    # Where a call's time goes: each of its launches, from the profiler.
    launch_ms = profiled_launch_ms(work["ms"])
    # Against the explicit gradient in f32 from the same bf16 inputs: the
    # kernel's error and the library's (SDPA's backward).
    oracle = attention_backward_reference(*(t.float() for t in work["inputs"][shape][:5]),
                                          causal=True, window=cfg.window_size)
    errors = {"kernel": gradient_errors(work["ms"][0](), oracle),
              "library": gradient_errors(work["library_ms"][0](), oracle)}
    del oracle
    emit({"phase": "train_flash_backward", "arch": cfg.name, "route": "cuda",
          "calls": n_fl, "shape": list(shape[:4]) + [hd], "window": cfg.window_size,
          **times, "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
          "ops_bound_ms": work["ops_ms"], "bytes_bound_ms": work["bytes_ms"],
          "backward_ms_per_step": times["backward_ms"] / steps,
          "plain_ms_per_step": times["plain_ms"] / steps,
          "ms_over_library": times["backward_ms"] / times["library_backward_ms"],
          "share_of_bound": work["bound_ms"] / times["backward_ms"],
          "share_of_step_device_ms": times["backward_ms"] / steps / train["device_ms"],
          "share_of_step_wall": times["backward_ms"] / steps / train["mean_step_ms"],
          "profiled_ms_per_call_by_launch": launch_ms,
          "max_err_dq_dk_dv_vs_explicit_f32": errors, "tol_times_max_1_abs":
              FLASH_BWD_TOL[torch.bfloat16]})
    rows.append({"name": "flash_attention_backward", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
                 "launches": n_fl, "max_abs_err": errs["flash_backward"],
                 "ms": times["backward_ms"], "plain_ms": times["plain_ms"],
                 "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
                 "library_ms": times["library_backward_ms"]})
    return rows


def flash_backward_work(shapes, gen) -> dict:
    """The backward kernel's launches at ``shapes`` (b, h, kv, sq, skv, d,
    causal, window), bf16 in the model's layout: the calls of the kernel,
    of its plain version (the explicit gradient) and of SDPA's backward on
    the same inputs (the forward kernel's too); and the bound of the work:
    five products of 2 d FLOPs a visible (query, key) pair at the bf16
    peak, against q, k, v, O, dO and lse read and dq, dk, dv written once."""
    inputs, lib_graphs, masks = {}, {}, {}
    flops = nbytes = 0
    for shape in shapes:
        b, h, kv, sq, skv, d, causal, window = shape
        pairs = visible_pairs(sq, window) if causal else sq * skv
        flops += 10 * b * h * d * pairs
        nbytes += 2 * b * d * (4 * h * sq + 4 * kv * skv) + 4 * b * h * sq
        if shape in inputs:
            continue
        inputs[shape] = flash_backward_inputs(*shape, torch.bfloat16, gen)
        q, k, v, _out, _d_out, _lse = inputs[shape]
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lib_graphs[shape] = ((ql, kl, vl), flash_library(ql, kl, vl, causal, window, masks))

    def kernel(shape):
        q, k, v, out, d_out, lse = inputs[shape]
        return lambda: flash_kernel.flash_attention_backward_cuda(
            q, k, v, out, d_out, lse, causal=shape[6], window=shape[7])

    def plain(shape):
        q, k, v, out, d_out, _lse = inputs[shape]
        return lambda: attention_backward_reference(q, k, v, out, d_out, causal=shape[6],
                                                    window=shape[7])

    def library(shape):
        (leaves, lib_out), d_out = lib_graphs[shape], inputs[shape][4]
        return lambda: torch.autograd.grad(lib_out, leaves, d_out, retain_graph=True)

    def forward(shape):
        q, k, v = inputs[shape][:3]
        return lambda: flash_kernel.flash_attention_cuda(q, k, v, causal=shape[6],
                                                         window=shape[7])

    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"inputs": inputs, "ms": [kernel(s) for s in shapes],
            "plain_ms": [plain(s) for s in shapes],
            "library_ms": [library(s) for s in shapes],
            "forward_ms": [forward(s) for s in shapes], "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


# ---------------------------------------------------------------------------
# The other block families: MoE, xLSTM, encoder-decoder, the ViT prefix
# ---------------------------------------------------------------------------


def flash_launch(cfg, b, sq, skv, causal, window=0):
    return (b, cfg.num_heads, cfg.num_kv_heads, sq, skv, cfg.head_dim, causal, window)


def serve_path(phase: str, serve: dict, scale_dtype=torch.bfloat16) -> dict:
    """A decoder-only serving path's kernel launches as shapes: per prefill
    of S tokens, ``pass_norms`` RMS norms of [S, D] and a flash launch per
    attention layer; per tick of R rows, ``pass_norms`` RMS norms of [R, D]."""
    cfg = serve["cfg"]
    norms = [(s, cfg.d_model) for s in serve["prefill_lens"]] \
        + [(r, cfg.d_model) for r in serve["tick_rows"]]
    flash = [flash_launch(cfg, 1, s, s, True, cfg.window_size if kind == "local" else 0)
             for kind, n in cfg.layer_counts().items() if kind in lm.ATTN_KINDS
             for s in serve["prefill_lens"] for _ in range(n)]
    return {"phase": phase, "launches": serve["launches"],
            "rmsnorm": [r for r in norms for _ in range(pass_norms(cfg))],
            "flash": flash, "scale_dtype": scale_dtype}


def train_path(phase: str, cfg, batch: int, seq: int, steps: int, launches: dict,
               enc_seq: int = 0) -> dict:
    """A training path's kernel launches as shapes: every norm of a step at
    [batch * seq, D] (the encoder's at [batch * enc_seq, D]) with an f32
    scale, every flash launch at the step's sequence lengths (each forward
    twice, remat), and one flash backward launch per attention."""
    per = expected_train_launches(cfg)
    if cfg.encoder_layers:
        ne, nd = cfg.encoder_layers, cfg.num_layers
        norms = ([(batch * enc_seq, cfg.d_model)] * (4 * ne + 1)
                 + [(batch * seq, cfg.d_model)] * (6 * nd + 1))
        backward = ([flash_launch(cfg, batch, enc_seq, enc_seq, False)] * ne
                    + [flash_launch(cfg, batch, seq, seq, True)] * nd
                    + [flash_launch(cfg, batch, seq, enc_seq, False)] * nd)
    else:
        norms = [(batch * seq, cfg.d_model)] * per["rmsnorm"]
        backward = [flash_launch(cfg, batch, seq, seq, True)] * per["flash_backward"]
    return {"phase": phase, "launches": launches, "rmsnorm": norms * steps,
            "flash": backward * 2 * steps, "flash_backward": backward * steps,
            "scale_dtype": torch.float32}


def check_counts(phase: str, launches: dict, expected: dict, variant: str) -> None:
    """Launch counts equal to the expected ones, every flash launch, forward
    and backward, through ``variant``'s kernel."""
    got = {k: launches[k] for k in expected}
    variants = {"forward": dict(flash_kernel.LAUNCHES_BY_VARIANT),
                "backward": dict(flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT)}
    want = {way: {v: expected.get(key, 0) if v == variant else 0 for v in variants[way]}
            for way, key in (("forward", "flash"), ("backward", "flash_backward"))}
    if got != expected or variants != want:
        raise SystemExit(f"{phase}: launches {got} {variants} != expected {expected} "
                         f"all through {variant}")


def params_at(cfg, dtype):
    specs = steps_mod.model_param_specs(cfg)
    t0 = time.perf_counter()
    params = init_params(specs, 0, "cuda", dtype)
    torch.cuda.synchronize()
    return params, count_params(specs), time.perf_counter() - t0


def serve_maverick() -> dict:
    """llama4-maverick at full width, one period deep, in bf16: the engine
    (one slot) against offline greedy decode, with its launches counted."""
    cfg = cut(MAVERICK, MAVERICK_LAYERS, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    serve = serve_check(MAVERICK, "serve_maverick", cfg, MAVERICK_MAX_SEQ,
                        lambda rng, vocab: make_requests(
                            rng, MAVERICK_REQUESTS, MAVERICK_PROMPT, SERVE_NEW, vocab),
                        slots=1)
    emit({"phase": "serve_maverick_memory", "arch": MAVERICK,
          "params": count_params(lm.lm_param_specs(cfg)),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "wall_s": time.perf_counter() - t0})
    return serve_path("serve_maverick", serve)


def train_steps(cfg, batches, steps: int, phase: str, **extra) -> dict:
    """``make_train_step`` at ``cfg`` with f32 parameters and AdamW state:
    ``steps`` steps on ``batches(step)``, each timed and its launches
    counted; every step's launches must be the expected ones, all flash
    launches through wgmma.  Returns the params (for a prefill after) and
    the path."""
    params, n_params, init_s = params_at(cfg, torch.float32)
    opt_cfg = adamw.AdamWConfig()
    opt_state = adamw.init_state(params, opt_cfg)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, peak_lr=3e-4, warmup_steps=1,
                                        total_steps=steps + 1)
    expected = expected_train_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for step in range(steps):
        batch = batches(step)
        before = current_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch, step)
        metrics = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = current_launches()
        tokens = batch["tokens"].numel()
        rows.append({"step": step, **metrics, "ms": ms,
                     "tokens_per_s": tokens / ms * 1e3,
                     "launches": {k: after[k] - before[k] for k in after}})
    launches = current_launches()
    emit({"phase": phase, "arch": cfg.name, "num_layers": cfg.num_layers,
          "encoder_layers": cfg.encoder_layers, "layer_kinds": cfg.layer_counts(),
          "d_model": cfg.d_model, "params": n_params, "init_params_s": init_s,
          "param_dtype": "float32", "compute_dtype": cfg.compute_dtype,
          "state_dtype": opt_cfg.state_dtype, "remat": cfg.remat,
          "batch_shape": list(batch["tokens"].shape),
          "ln_vocab": math.log(cfg.vocab_size), "steps": rows,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "expected_launches_per_step": expected,
          "flash_launches_by_variant": dict(flash_kernel.LAUNCHES_BY_VARIANT),
          "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
          **extra})
    for r in rows:
        if not all(math.isfinite(v) for k, v in r.items() if k != "launches"):
            raise SystemExit(f"{phase}: step {r['step']} is not finite: {r}")
        if r["launches"] != expected:
            raise SystemExit(f"{phase}: step {r['step']} launches {r['launches']} "
                             f"!= expected {expected}")
    if abs(rows[0]["ce_loss"] - math.log(cfg.vocab_size)) > 2.0:
        raise SystemExit(f"{phase}: first CE {rows[0]['ce_loss']} is far from ln V")
    check_counts(phase, launches, {k: v * steps for k, v in expected.items()}, "wgmma")
    del opt_state
    return {"params": params, "launches": launches}


def train_xlstm() -> dict:
    cfg = cut(XLSTM, XLSTM_TRAIN_LAYERS, compute_dtype=get_config(XLSTM).compute_dtype)
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0), "cuda")
    launches = train_steps(cfg, pipe.get, XLSTM_TRAIN_STEPS, "train_xlstm",
                           depth_cut=f"{XLSTM_TRAIN_LAYERS} of "
                                     f"{get_config(XLSTM).num_layers} layers")["launches"]
    torch.cuda.empty_cache()
    return train_path("train_xlstm", cfg, TRAIN_BATCH, TRAIN_SEQ, XLSTM_TRAIN_STEPS,
                      launches)


def grad_fingerprint(cfg, params, batch, rules=None) -> tuple[bytes, list[int]]:
    """The loss's bits and a checksum of every gradient's bits, for one
    forward and backward of ``batch`` from ``params`` (with ``rules``:
    DTensors on a one-card mesh, whose local shards are the whole
    tensors)."""
    leaves = adamw.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        with lm.spmd(rules):
            loss, _m = steps_mod.loss_fn_for(cfg, 1, rules)(params, batch)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    if rules is not None:
        loss, grads = loss.to_local(), [g.to_local() for g in grads]
    sums = [int(g.view(torch.int32).sum(dtype=torch.int64)) for g in grads]
    return loss.detach().cpu().numpy().tobytes(), sums


def train_moe() -> dict:
    """olmoe-1b-7b cut to 6 layers, B 1 x S 2048, f32 state, under
    deterministic algorithms: 3 steps, then one forward and backward
    replayed twice from the same parameters, bit for bit."""
    cfg = cut(OLMOE, MOE_TRAIN_LAYERS, compute_dtype="bfloat16")
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0), "cuda")
    torch.use_deterministic_algorithms(True)
    try:
        out = train_steps(cfg, pipe.get, MOE_TRAIN_STEPS, "train_moe",
                          depth_cut=f"{MOE_TRAIN_LAYERS} of {get_config(OLMOE).num_layers} "
                                    f"layers",
                          capacity_factor=cfg.capacity_factor)
        launches = out["launches"]
        batch = pipe.get(MOE_TRAIN_STEPS)
        first = grad_fingerprint(cfg, out["params"], batch)
        again = grad_fingerprint(cfg, out["params"], batch)
    finally:
        torch.use_deterministic_algorithms(False)
    same = first == again
    emit({"phase": "train_moe_replay", "arch": cfg.name, "loss_bits_equal": first[0] == again[0],
          "gradient_checksums_equal": first[1] == again[1], "leaves": len(first[1]),
          "ok": same})
    if not same:
        raise SystemExit("train_moe: a replayed forward and backward differs")
    del out
    torch.cuda.empty_cache()
    return train_path("train_moe", cfg, TRAIN_BATCH, TRAIN_SEQ, MOE_TRAIN_STEPS, launches)


def encdec_expected(cfg, encodes: int, steps: int, decodes: int) -> dict[str, int]:
    """Launches of ``encodes`` encoder passes, ``steps`` decode steps and
    ``decodes`` full decoder passes of an encoder-decoder."""
    ne, nd = cfg.encoder_layers, cfg.num_layers
    return {"mandelbrot": 0, "rglru": 0,
            "rmsnorm": encodes * (2 * ne + 1) + (steps + decodes) * (3 * nd + 1),
            "flash": encodes * ne + decodes * 2 * nd}


def greedy_encdec(cfg, params, enc_out, new: int):
    """``new`` greedy tokens from token 1 through ``encdec_decode_step``:
    (the fed tokens [B, new], each step's logits, each step's ms)."""
    B = enc_out.shape[0]
    cache = encdec_mod.init_encdec_cache(cfg, params, enc_out, new)
    tok = torch.ones((B, 1), dtype=torch.int64, device="cuda")
    fed, logits, ms = [], [], []
    for t in range(new):
        start = time.perf_counter()
        lg, cache = encdec_mod.encdec_decode_step(cfg, params, cache, tok, t)
        fed.append(tok)
        logits.append(lg[:, 0])
        tok = torch.argmax(lg[:, :, :cfg.vocab_size], dim=-1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
    return torch.cat(fed, dim=1), logits, ms


def encdec_phases() -> list[dict]:
    """seamless-m4t-large-v2: the decode-vs-forward check (4 + 4 layers,
    f32), the bf16 path at full depth (encode, cross cache, greedy decode)
    and one train step at full depth."""
    base = get_config(SEAMLESS)
    gen = torch.Generator("cuda").manual_seed(9)
    cfg = cut(SEAMLESS, ENCDEC_CHECK_LAYERS, encoder_layers=ENCDEC_CHECK_LAYERS)
    params, _n, _s = params_at(cfg, torch.float32)
    randomize_small_params(params, gen)
    frames = torch.randn((ENCDEC_BATCH, ENCDEC_CHECK_FRAMES, cfg.d_model), generator=gen,
                         device="cuda")
    reset_launches()
    enc_out = encdec_mod.encode(cfg, params, frames)
    fed, step_logits, _ms = greedy_encdec(cfg, params, enc_out, ENCDEC_CHECK_TOKENS)
    full = encdec_mod.decode_train(cfg, params, fed, enc_out) @ params["lm_head"]
    err = max(float((lg - full[:, t]).abs().max()) for t, lg in enumerate(step_logits))
    torch.cuda.synchronize()
    check_counts("encdec_check", current_launches(),
                 encdec_expected(cfg, 1, ENCDEC_CHECK_TOKENS, 1), "f32")
    ok = err <= ENCDEC_TOL
    emit({"phase": "encdec_check", "arch": SEAMLESS, "d_model": cfg.d_model,
          "depth_cut": f"{cfg.encoder_layers} + {cfg.num_layers} of "
                       f"{base.encoder_layers} + {base.num_layers} layers",
          "compute_dtype": cfg.compute_dtype, "frames": list(frames.shape),
          "tokens": ENCDEC_CHECK_TOKENS, "max_abs_err_step_vs_forward": err,
          "tol": ENCDEC_TOL, "launches": current_launches(), "ok": ok})
    if not ok:
        raise SystemExit(f"encdec: decode steps differ from the forward by {err}")
    del params, enc_out, full
    torch.cuda.empty_cache()

    cfg = base
    params, n_params, init_s = params_at(cfg, torch.bfloat16)
    frames = torch.randn((ENCDEC_BATCH, ENCDEC_FRAMES, cfg.d_model), generator=gen,
                         device="cuda")
    encdec_mod.encode(cfg, params, frames[:, :64])  # warm-up
    greedy_encdec(cfg, params, encdec_mod.encode(cfg, params, frames[:, :64]), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    enc_out = encdec_mod.encode(cfg, params, frames)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    fed, logits, step_ms = greedy_encdec(cfg, params, enc_out, ENCDEC_NEW)
    launches = current_launches()
    check_counts("encdec_serve", launches, encdec_expected(cfg, 1, ENCDEC_NEW, 0), "wgmma")
    finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
    in_vocab = bool(((fed >= 0) & (fed < cfg.vocab_size)).all())
    emit({"phase": "encdec_serve", "arch": SEAMLESS, "encoder_layers": cfg.encoder_layers,
          "num_layers": cfg.num_layers, "d_model": cfg.d_model, "params": n_params,
          "weights_dtype": "bfloat16", "init_params_s": init_s,
          "frames": list(frames.shape), "new_tokens": ENCDEC_NEW, "encode_ms": encode_ms,
          "decode_step_ms": step_ms, "decode_ms_per_step_after_first":
              statistics.mean(step_ms[1:]),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "finite": finite, "ok": finite and in_vocab})
    if not (finite and in_vocab):
        raise SystemExit("encdec: bf16 decode gave a non-finite logit or a token "
                         "outside the vocabulary")
    del params, enc_out
    torch.cuda.empty_cache()
    serve = {"phase": "encdec_serve", "launches": launches, "scale_dtype": torch.bfloat16,
             "rmsnorm": [(ENCDEC_BATCH * ENCDEC_FRAMES, cfg.d_model)]
             * (2 * cfg.encoder_layers + 1)
             + [(ENCDEC_BATCH, cfg.d_model)] * ((3 * cfg.num_layers + 1) * ENCDEC_NEW),
             "flash": [flash_launch(cfg, ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_FRAMES, False)]
             * cfg.encoder_layers}

    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, ENCDEC_TRAIN_SEQ, TRAIN_BATCH, seed=0,
                                    d_model=cfg.d_model, encdec=True), "cuda")
    launches = train_steps(cfg, pipe.get, 1, "train_encdec",
                           frames=[TRAIN_BATCH, ENCDEC_TRAIN_SEQ, cfg.d_model])["launches"]
    torch.cuda.empty_cache()
    return [serve, train_path("train_encdec", cfg, TRAIN_BATCH, ENCDEC_TRAIN_SEQ, 1,
                              launches, enc_seq=ENCDEC_TRAIN_SEQ)]


def train_vlm() -> list[dict]:
    """internvl2-2b at full depth: 2 train steps with the ViT stub's 256
    embeddings as the prefix, then one bf16 prefill step with them."""
    cfg = get_config(VLM)
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0,
                                    frontend_len=cfg.frontend_len, d_model=cfg.d_model),
                        "cuda")
    out = train_steps(cfg, pipe.get, VLM_TRAIN_STEPS, "train_vlm",
                      extra_embeds=[TRAIN_BATCH, cfg.frontend_len, cfg.d_model])
    train = train_path("train_vlm", cfg, TRAIN_BATCH, TRAIN_SEQ, VLM_TRAIN_STEPS,
                       out["launches"])
    params = adamw.tree_map(lambda p: p.to(torch.bfloat16), out["params"])
    del out
    torch.cuda.empty_cache()
    batch = pipe.get(VLM_TRAIN_STEPS)
    prefill = steps_mod.make_prefill_step(cfg)
    prefill(params, {"tokens": batch["tokens"][:, :64],
                     "extra_embeds": batch["extra_embeds"][:, :32]})  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": batch["tokens"], "extra_embeds": batch["extra_embeds"]})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = current_launches()
    check_counts("prefill_vlm", launches, expected_launches(cfg, 1, 0), "wgmma")
    ok = (tuple(logits.shape) == (TRAIN_BATCH, cfg.padded_vocab(1))
          and bool(torch.isfinite(logits).all()))
    emit({"phase": "prefill_vlm", "arch": VLM, "weights_dtype": "bfloat16",
          "tokens": list(batch["tokens"].shape),
          "extra_embeds": list(batch["extra_embeds"].shape), "ms": ms,
          "logits": list(logits.shape), "launches": launches, "ok": ok})
    if not ok:
        raise SystemExit("internvl2-2b: the prefill step's logits are wrong")
    del params
    torch.cuda.empty_cache()
    pre = serve_path("prefill_vlm", {"cfg": cfg, "prefill_lens": [TRAIN_SEQ],
                                     "tick_rows": [], "launches": launches})
    return [train, pre]


def other_families() -> list[dict]:
    """Every phase of the other block families, in order; each returns its
    path's kernel launches as shapes, for ``by_path``."""
    paths = []
    serve_check(OLMOE, "serve_check_moe", cut(OLMOE, MOE_CHECK_LAYERS), YI_CHECK_MAX_SEQ,
                lambda rng, vocab: make_requests(rng, CHECK_REQUESTS, YI_CHECK_PROMPT,
                                                 CHECK_NEW, vocab))
    paths.append(serve_path("serve_moe", serve_full(
        OLMOE, "serve_moe", YI_SERVE_MAX_SEQ,
        lambda rng, vocab: make_requests(rng, SERVE_REQUESTS, YI_SERVE_PROMPT,
                                         SERVE_NEW, vocab), profile=True)))
    paths.append(serve_maverick())
    serve_check(XLSTM, "serve_check_xlstm",
                cut(XLSTM, len(XLSTM_CHECK_PATTERN), layer_pattern=XLSTM_CHECK_PATTERN),
                YI_CHECK_MAX_SEQ,
                lambda rng, vocab: make_requests(rng, CHECK_REQUESTS, YI_CHECK_PROMPT,
                                                 CHECK_NEW, vocab))
    paths.append(serve_path("serve_xlstm", serve_full(
        XLSTM, "serve_xlstm", YI_SERVE_MAX_SEQ,
        lambda rng, vocab: make_requests(rng, SERVE_REQUESTS, YI_SERVE_PROMPT,
                                         SERVE_NEW, vocab), profile=False)))
    paths.append(train_xlstm())
    paths.append(train_moe())
    paths += encdec_phases()
    paths += train_vlm()
    return paths


def by_path_bound_ms(kernel: str, shapes, scale_bytes: int) -> tuple[float, str]:
    """The least time of a path's launches: bytes at HBM_BW (each input read
    once, each output written once) and, for flash, its products at the
    bf16 tensor-core peak; the larger, and which it was."""
    if kernel == "rmsnorm":
        nbytes = sum(2 * n * d * 2 + d * scale_bytes for n, d in shapes)
        return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
    flops = nbytes = 0
    for b, h, kv, sq, skv, d, causal, window in shapes:
        pairs = visible_pairs(sq, window) if causal else sq * skv
        flops += 4 * b * h * d * pairs
        nbytes += 2 * b * d * (2 * h * sq + 2 * kv * skv)
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def flash_library(q, k, v, causal: bool, window: int, masks: dict):
    """``scaled_dot_product_attention`` on the kernel's inputs: causal, a
    band mask where a window cuts the prompt, or no mask."""
    sq = q.shape[2]
    if causal and 0 < window < sq:
        key = (sq, window)
        if key not in masks:
            masks[key] = torch.ones((sq, sq), dtype=torch.bool, device="cuda"
                                    ).tril().triu(-(window - 1))
        return F.scaled_dot_product_attention(q, k, v, attn_mask=masks[key],
                                              enable_gqa=True)
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)


def by_path(paths: list[dict]) -> dict[str, dict[str, dict]]:
    """Each new path's RMS-norm, flash and flash backward launches replayed,
    launch for launch, at the shapes it gave them: {kernel: {path:
    {launches, ms, bound_ms, bound_by, library_ms}}}, the library call
    (``F.rms_norm``; SDPA; SDPA's backward) on the same inputs.  The
    replayed count must equal the count the path's run made."""
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    gen = torch.Generator("cuda").manual_seed(10)
    bf16 = torch.bfloat16
    out: dict[str, dict] = {"rmsnorm": {}, "flash": {}, "flash_backward": {}}
    for path in paths:
        rms_in, fl_in = {}, {}
        for n, d in path["rmsnorm"]:
            rms_in.setdefault((n, d), (
                torch.randn((n, d), generator=gen, device="cuda").to(bf16),
                (0.2 * torch.randn((d,), generator=gen, device="cuda")
                 ).to(path["scale_dtype"])))
        for launch in path["flash"]:
            b, h, kv, sq, skv, d, _causal, _window = launch
            fl_in.setdefault(launch, flash_inputs(b, h, kv, sq, skv, d, bf16, gen, True))

        weights = {shape: (1.0 + scale.float()).to(x.dtype)
                   for shape, (x, scale) in rms_in.items()}
        masks: dict = {}

        def rms_call(shape, inputs=rms_in):
            return lambda: rms_kernel.rms_norm_cuda(*inputs[shape])

        def rms_library(shape, inputs=rms_in):
            return lambda: F.rms_norm(inputs[shape][0], (shape[1],), weights[shape],
                                      1e-6)

        def flash_call(launch, inputs=fl_in):
            return lambda: flash_kernel.flash_attention_cuda(
                *inputs[launch], causal=launch[6], window=launch[7])

        def flash_lib(launch, inputs=fl_in):
            return lambda: flash_library(*inputs[launch], launch[6], launch[7], masks)

        scale_bytes = torch.empty((), dtype=path["scale_dtype"]).element_size()
        for kernel, shapes, make, library in (
                ("rmsnorm", path["rmsnorm"], rms_call, rms_library),
                ("flash", path["flash"], flash_call, flash_lib)):
            if len(shapes) != path["launches"].get(kernel, 0):
                raise SystemExit(f"{path['phase']}: replayed {len(shapes)} {kernel} "
                                 f"launches, the path made {path['launches'][kernel]}")
            if not shapes:
                continue
            for shape in set(shapes):
                make(shape)()  # warm-up, every shape once
                library(shape)()
            torch.cuda.synchronize()
            ms, paced = spun_device_ms([make(shape) for shape in shapes], clock_hz)
            lib_ms, lib_paced = spun_device_ms([library(shape) for shape in shapes],
                                               clock_hz)
            bound_ms, bound_by = by_path_bound_ms(kernel, shapes, scale_bytes)
            out[kernel][path["phase"]] = {"launches": len(shapes), "ms": ms,
                                          "host_paced": paced, "bound_ms": bound_ms,
                                          "bound_by": bound_by, "library_ms": lib_ms,
                                          "library_host_paced": lib_paced}
        del rms_in, fl_in, weights, masks
        shapes = path.get("flash_backward", [])
        if len(shapes) != path["launches"].get("flash_backward", 0):
            raise SystemExit(f"{path['phase']}: replayed {len(shapes)} flash backward "
                             f"launches, the path made {path['launches']['flash_backward']}")
        if shapes:
            work = flash_backward_work(shapes, gen)
            for fn in {s: fn for s, fn in zip(shapes, work["ms"])}.values():
                fn()  # warm-up, every shape once
            for fn in {s: fn for s, fn in zip(shapes, work["library_ms"])}.values():
                fn()
            torch.cuda.synchronize()
            ms, paced = spun_device_ms(work["ms"], clock_hz)
            lib_ms, lib_paced = spun_device_ms(work["library_ms"], clock_hz)
            out["flash_backward"][path["phase"]] = {
                "launches": len(shapes), "ms": ms, "host_paced": paced,
                "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
                "library_ms": lib_ms, "library_host_paced": lib_paced}
            del work
    emit({"phase": "by_path", **out})
    return out


# ---------------------------------------------------------------------------
# Part 6: sharding and the SPMD tools on one card
# ---------------------------------------------------------------------------


def placed(specs, params, rules):
    """A plain parameter tree as DTensors placed by ``rules`` (on a
    one-device mesh each leaf is its own shard: no copy)."""
    if not isinstance(specs, dict):
        return rules.distribute(params, specs.logical_axes)
    return {k: placed(specs[k], params[k], rules) for k in specs}


def local_tree(tree):
    """A DTensor tree's local shards (on one device: the whole tensors)."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    return tree.to_local()


def spmd_train(mesh, train: dict) -> dict:
    """recurrentgemma-2b at full width and depth, B 1 x S 2048, its train
    step traced by ``ClusterBuilder.build_step`` over a one-device mesh with
    ``training_rules`` (fake tensors: no allocation) and then run eagerly
    on DTensor parameters from ``init_params(..., rules=)``: a warm-up step
    and TRAIN_STEPS timed ones from ``train_full``'s parameters and
    batches.  Loss and grad norm must equal ``train_full``'s (within
    SPMD_TOL relative), every step's launches the expected ones."""
    cfg = get_config(RG)
    rules = training_rules(mesh)
    specs = lm.lm_param_specs(cfg, 1)
    params = init_params(specs, 0, "cuda", torch.float32, rules=rules)
    opt_cfg = adamw.AdamWConfig()
    opt_state = adamw.init_state(params, opt_cfg)
    step_fn = steps_mod.make_train_step(cfg, opt_cfg, tp=1, rules=rules,
                                        peak_lr=3e-4, warmup_steps=2,
                                        total_steps=TRAIN_STEPS + 2)
    pipe = DataPipeline(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0),
                        "cuda", rules)
    batch0 = pipe.get(0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    art = ClusterBuilder(mesh=mesh, rules=rules).build_step(
        step_fn, (params, opt_state, batch0, 0), name="spmd_train")
    trace_s = time.perf_counter() - t0
    trace_alloc = (torch.cuda.memory_allocated() - before,
                   torch.cuda.max_memory_allocated() - before)
    params, opt_state, m = art(params, opt_state, batch0, 0)
    first_loss = float(m["loss"].full_tensor())
    expected = expected_train_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows = []
    for step in range(1, TRAIN_STEPS + 1):
        batch = pipe.get(step)
        got = current_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt_state, m = art(params, opt_state, batch, step)
        loss = float(m["loss"].full_tensor())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        after = current_launches()
        rows.append({"step": step, "loss": loss,
                     "grad_norm": float(m["grad_norm"].full_tensor()), "ms": ms,
                     "launches": {k: after[k] - got[k] for k in after}})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain = train["steps"]
    diffs = [abs(first_loss - train["first_loss"]) / abs(train["first_loss"])]
    for r, p in zip(rows, plain):
        for k in ("loss", "grad_norm"):
            diffs.append(abs(r[k] - p[k]) / max(abs(p[k]), 1e-30))
    mem = art.memory()
    cost = art.cost()
    fl = step_flops(cfg, ShapeConfig("spmd_train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    mean_ms = statistics.mean(r["ms"] for r in rows)
    colls = art.collectives()
    emit({"phase": "spmd_train", "arch": cfg.name, "num_layers": cfg.num_layers,
          "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "trace_s": trace_s,
          "trace_device_bytes_allocated_and_peak": list(trace_alloc),
          "trace_ops": art.recorder.ops,
          "first_step_loss": first_loss, "plain_first_step_loss": train["first_loss"],
          "steps": rows, "plain_steps": [{k: p[k] for k in ("step", "loss", "grad_norm",
                                                             "ms")} for p in plain],
          "max_rel_diff": max(diffs), "tolerance": SPMD_TOL,
          "mean_step_ms": mean_ms, "plain_mean_step_ms": train["mean_step_ms"],
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3,
          "predicted_memory": dataclasses.asdict(mem),
          "predicted_live_gb": (mem.argument_size_in_bytes + mem.temp_size_in_bytes
                                + mem.output_size_in_bytes
                                - mem.alias_size_in_bytes) / 1e9,
          "peak_memory_gb": peak_gb, "plain_peak_memory_gb": train["peak_memory_gb"],
          "traced_flops": cost["flops_per_device"],
          "traced_bytes": cost["bytes_per_device"],
          "analytic_total_flops": fl.total, "model_flops": fl.model_flops,
          "mfu": fl.model_flops / (mean_ms / 1e3 * PEAK_FLOPS_BF16),
          "plain_mfu": fl.model_flops / (train["mean_step_ms"] / 1e3 * PEAK_FLOPS_BF16),
          "collectives": {k: n for k, (n, _b) in colls.by_kind().items()},
          "expected_launches_per_step": expected})
    if max(diffs) > SPMD_TOL:
        raise SystemExit(f"spmd_train: loss or grad norm {max(diffs)} (relative) from "
                         f"the unsharded step")
    for r in rows:
        if r["launches"] != expected:
            raise SystemExit(f"spmd_train step {r['step']}: launches {r['launches']} "
                             f"!= expected {expected}")
    if trace_alloc[0] or art.recorder.real_inputs:
        raise SystemExit(f"spmd_train: the fake trace left {trace_alloc[0]} bytes on "
                         f"the card; ops on real tensors: {art.recorder.real_inputs[:5]}")
    del params, opt_state, art, m, batch0
    torch.cuda.empty_cache()
    return {"mean_step_ms": mean_ms}


def serve_engine(cfg, params, reqs, max_seq: int, slots: int, rules=None) -> dict:
    """One engine over ``reqs`` with the serve phases' submission pattern
    (half, 3 ticks, the rest): completions by rid, ticks, decode ms a tick
    and the kernels' launches."""
    engine = ServingEngine(cfg, params, max_slots=slots, max_seq=max_seq,
                           tp=1, rules=rules)
    warm = [Request(rid=-1, prompt=list(range(1, 65)), max_new_tokens=2)]
    for r in warm:  # cuBLAS handles, DTensor's sharding caches
        engine.submit(r)
    engine.run_until_drained()
    engine.completions.clear()
    engine.timing = type(engine.timing)()
    torch.cuda.synchronize()
    reset_launches()
    ticks = 0
    t0 = time.perf_counter()
    half = len(reqs) // 2
    for r in reqs[:half]:
        engine.submit(r)
    for _ in range(3):
        ticks += engine.step() > 0
    for r in reqs[half:]:
        engine.submit(r)
    while engine.queue or (engine.slot_rid >= 0).any():
        ticks += engine.step() > 0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    done = engine.shutdown()
    launches = {name: module.LAUNCHES for name, module in KERNELS.items()}
    return {"tokens": {c.rid: c.tokens for c in done}, "ticks": ticks,
            "wall_s": wall_s, "prefills": len(done),
            "tokens_per_s": sum(len(c.tokens) - c.prompt_len for c in done) / wall_s,
            "decode_ms_per_tick": engine.timing.node("host").run_ms / ticks,
            "launches": launches}


def spmd_serve(mesh) -> None:
    """yi-9b through ``ServingEngine(tp=1, rules=decode_rules(mesh))`` and
    through the engine without rules, on the same weights and requests:
    the tokens must be equal, the ticks are printed side by side.  First a
    depth cut in float32 whose sharded completions equal offline greedy
    decode."""
    rules = decode_rules(mesh)
    # the float32 check: engine with rules == offline greedy, launches exact
    cfg = cut(YI, YI_CHECK_LAYERS)
    specs = lm.lm_param_specs(cfg)
    plain = init_params(specs, 0, "cuda", torch.float32)
    randomize_small_params(plain, torch.Generator("cuda").manual_seed(2))
    reqs = make_requests(np.random.default_rng(0), CHECK_REQUESTS, YI_CHECK_PROMPT,
                         CHECK_NEW, cfg.vocab_size)
    got = serve_engine(cfg, placed(specs, plain, rules), reqs, YI_CHECK_MAX_SEQ,
                       SERVE_SLOTS, rules)
    mismatched = [r.rid for r in reqs if got["tokens"][r.rid][len(r.prompt):]
                  != offline_greedy(cfg, plain, r.prompt, CHECK_NEW, YI_CHECK_MAX_SEQ)]
    expected = expected_launches(cfg, got["prefills"], got["ticks"])
    emit({"phase": "spmd_serve_check", "arch": YI, "num_layers": cfg.num_layers,
          "compute_dtype": cfg.compute_dtype, "requests": len(reqs),
          "mismatched_rids": mismatched, "launches": got["launches"],
          "expected_launches": expected})
    if mismatched or got["launches"] != expected:
        raise SystemExit(f"spmd_serve_check: sharded engine != offline greedy for "
                         f"{mismatched}, or launches {got['launches']} != {expected}")
    del plain, got
    torch.cuda.empty_cache()

    cfg = get_config(YI)
    specs = lm.lm_param_specs(cfg)
    params = init_params(specs, 0, "cuda", torch.bfloat16, rules=rules)
    reqs = make_requests(np.random.default_rng(0), SERVE_REQUESTS, YI_SERVE_PROMPT,
                         SERVE_NEW, cfg.vocab_size)
    runs = {}
    for name, p, r in (("plain", local_tree(params), None), ("sharded", params, rules),
                       ("plain_again", local_tree(params), None)):
        runs[name] = serve_engine(cfg, p, reqs, YI_SERVE_MAX_SEQ, SERVE_SLOTS, r)
    same = all(runs[n]["tokens"] == runs["plain"]["tokens"] for n in runs)
    expected = expected_launches(cfg, runs["sharded"]["prefills"],
                                 runs["sharded"]["ticks"])
    emit({"phase": "spmd_serve", "arch": YI, "num_layers": cfg.num_layers,
          "weights_dtype": "bfloat16", "requests": len(reqs),
          "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          **{f"{n}_{k}": v[k] for n, v in runs.items()
             for k in ("decode_ms_per_tick", "tokens_per_s", "wall_s", "ticks")},
          "tokens_equal": same, "sharded_launches": runs["sharded"]["launches"],
          "expected_launches": expected})
    if not same:
        raise SystemExit("spmd_serve: the sharded engine's tokens differ from the plain one's")
    if runs["sharded"]["launches"] != expected:
        raise SystemExit(f"spmd_serve: launches {runs['sharded']['launches']} != {expected}")
    del params, runs
    torch.cuda.empty_cache()


def greedy(cfg, params, prompt, n: int, max_seq: int, tp: int):
    """(last prompt logits [Vp], ``n`` greedy tokens) at degree ``tp``."""
    logits, cache = lm.prefill(cfg, params, torch.tensor([prompt], device="cuda"),
                               max_seq, tp=tp)
    first = logits[0, 0]
    out = [int(torch.argmax(first[: cfg.vocab_size]))]
    for i in range(n - 1):
        lg, cache = lm.decode_step(cfg, params, cache,
                                   torch.tensor([[out[-1]]], device="cuda"),
                                   len(prompt) + i, tp=tp)
        out.append(int(torch.argmax(lg[0, 0, : cfg.vocab_size])))
    return first, out


def tp_plan() -> None:
    """The padded plans at tp = 16 on one card, full width, float32, cut in
    depth: phi3-medium-14b (grouped: 40 / 10 heads padded to 48 / 12) and
    llama4-maverick, one period (expand_kv: 48 query heads over 8 KV
    heads).  The tp = 16 parameters are the tp = 1 ones carried by
    ``convert.pad_for_tp`` (a leaf it does not widen is shared).  Logits
    within TP_TOL of tp = 1's, the greedy tokens equal, every flash launch
    at tp = 16 at 48 query heads through the float32 variant."""
    seen = []
    kernel_fn = flash_ops.flash_attention_cuda

    def recording(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], str(q.dtype)))
        return kernel_fn(q, k, v, **kw)

    for arch, layers in ((PHI3, 2), (MAVERICK, MAVERICK_LAYERS)):
        cfg = cut(arch, layers)
        plan = lm.head_plan(cfg, TP_PLAN)
        torch.cuda.reset_peak_memory_stats()
        p1 = init_params(lm.lm_param_specs(cfg), 0, "cuda", torch.float32)
        randomize_small_params(p1, torch.Generator("cuda").manual_seed(4))
        p16 = pad_for_tp(cfg, p1, TP_PLAN)
        prompt = np.random.default_rng(5).integers(
            0, cfg.vocab_size, TP_PLAN_PROMPT).tolist()
        l1, t1 = greedy(cfg, p1, prompt, TP_PLAN_NEW, TP_PLAN_MAX_SEQ, 1)
        seen.clear()
        flash_ops.flash_attention_cuda = recording
        try:
            l16, t16 = greedy(cfg, p16, prompt, TP_PLAN_NEW, TP_PLAN_MAX_SEQ, TP_PLAN)
        finally:
            flash_ops.flash_attention_cuda = kernel_fn
        err = float((l1[: cfg.vocab_size] - l16[: cfg.vocab_size]).abs().max())
        want = [(plan["Hp"], plan["Hp"] if plan["mode"] == "expand_kv" else plan["Kp"],
                 "torch.float32")] * sum(
            n for kind, n in cfg.layer_counts().items() if kind in lm.ATTN_KINDS)
        emit({"phase": "tp_plan", "arch": arch, "num_layers": cfg.num_layers,
              "tp": TP_PLAN, "plan": plan, "heads": [cfg.num_heads, cfg.num_kv_heads],
              "vocab": [cfg.vocab_size, cfg.padded_vocab(TP_PLAN)],
              "prompt": len(prompt), "max_abs_logit_diff": err, "tolerance": TP_TOL,
              "tokens_tp1": t1, "tokens_tp16": t16,
              "flash_launches_tp16": seen, "peak_memory_gb":
                  torch.cuda.max_memory_allocated() / 1e9})
        if err > TP_TOL or t1 != t16:
            raise SystemExit(f"tp_plan {arch}: logits {err} > {TP_TOL} or tokens differ")
        if seen != want:
            raise SystemExit(f"tp_plan {arch}: flash launches {seen} != {want}")
        del p1, p16, l1, l16
        torch.cuda.empty_cache()


def dryrun_phase() -> None:
    """``python -m repro_torch.launch.dryrun`` on the 16 x 16 fake mesh for
    yi-9b's decode_32k and train_4k, and ``launch.roofline`` for
    decode_32k, each a process of its own on the card's host (one fake
    process group of 256 ranks each): the device memory allocated after the
    trace must be what it was before (the peak is printed), and the
    per-device GiB, the collectives by kind and the FLOPs are printed."""
    out = Path(tempfile.mkdtemp(prefix="dryrun_", dir=Path(__file__).parent / "build"))
    env = _child_env()
    for shape in ("decode_32k", "train_4k"):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        YI, "--shape", shape, "--out", str(out / "dryrun")],
                       check=True, env=env, timeout=DRYRUN_TIMEOUT_S)
        r = json.loads((out / "dryrun" / f"{YI}__{shape}__single.json").read_text())
        mem = r["memory"]
        emit({"phase": "dryrun", "arch": YI, "shape": shape, "mesh": r["mesh"],
              "command_s": time.perf_counter() - t0, "trace_s": r["load_compile_s"],
              "gib_per_device": mem["live_bytes_per_device"] / 2**30,
              "hbm_gib": mem["live_bytes_per_device"] / mem["hbm_fraction"] / 2**30
              if mem["hbm_fraction"] else None,
              "memory": mem, "collectives": r["collectives"],
              "flops_per_device": r["cost_analysis"]["flops_per_device"],
              "bytes_per_device": r["cost_analysis"]["bytes_per_device"],
              "model_flops_global": r["model_flops_global"],
              "device_bytes_before_after_peak": r["device_bytes_before_after_peak"]})
        before, after, _peak = r["device_bytes_before_after_peak"]
        if not r["ok"] or before != after:
            raise SystemExit(f"dryrun {shape}: {r}")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--arch", YI,
                    "--shape", "decode_32k", "--out", str(out / "roofline")],
                   check=True, env=env, timeout=DRYRUN_TIMEOUT_S)
    r = json.loads((out / "roofline" / f"{YI}__decode_32k.json").read_text())
    emit({"phase": "roofline", "arch": YI, "shape": "decode_32k",
          "command_s": time.perf_counter() - t0, **{k: r[k] for k in (
              "terms_seconds", "dominant", "useful_ratio", "roofline_fraction",
              "collectives_by_kind", "per_device")}})
    if not r["ok"]:
        raise SystemExit(f"roofline: {r}")
    shutil.rmtree(out, ignore_errors=True)


def spmd_train_moe(mesh) -> None:
    """olmoe-1b-7b at full width cut to MOE_SPMD_LAYERS layers, bf16
    compute, f32 parameters, under ``remat_policy="dots"`` and
    deterministic algorithms: one forward and backward of a B 1 x S 2048
    batch on plain tensors, then on DTensors placed by ``training_rules``
    over the one-card mesh, where the MoE FFN takes the expert-parallel
    path (``_shard.run_split``; one card holds every expert, so there is no
    slot sum to make).  Loss and gradient bits must be equal, and each
    pass's launches the expected ones."""
    cfg = cut(OLMOE, MOE_SPMD_LAYERS, compute_dtype="bfloat16", remat_policy="dots")
    rules = training_rules(mesh)
    specs = lm.lm_param_specs(cfg, 1)
    params = init_params(specs, 0, "cuda", torch.float32)
    source = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    splits = []
    core = moe_mod._moe_core

    def recorded(x, p, **kw):
        part = kw.get("part")
        splits.append(None if part is None else (part.offset, part.size, part.dims))
        return core(x, p, **kw)

    prints, passes, secs = {}, {}, {}
    moe_mod._moe_core = recorded
    torch.use_deterministic_algorithms(True)
    try:
        for name, args in (
                ("plain", (params, DataPipeline(source, "cuda").get(0))),
                ("expert_parallel", (placed(specs, params, rules),
                                     DataPipeline(source, "cuda", rules).get(0), rules))):
            reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            prints[name] = grad_fingerprint(cfg, *args)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
            passes[name] = current_launches()
    finally:
        torch.use_deterministic_algorithms(False)
        moe_mod._moe_core = core
    expected = expected_train_launches(cfg)
    # forward and recompute, per MoE layer: plain, then the split path
    want_splits = ([None] * 2 * MOE_SPMD_LAYERS
                   + [(0, cfg.num_experts, ())] * 2 * MOE_SPMD_LAYERS)
    same = prints["plain"] == prints["expert_parallel"]
    emit({"phase": "spmd_train_moe", "arch": cfg.name, "num_layers": cfg.num_layers,
          "depth_cut": f"{MOE_SPMD_LAYERS} of {get_config(OLMOE).num_layers} layers",
          "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          "remat_policy": cfg.remat_policy, "compute_dtype": cfg.compute_dtype,
          "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "num_experts": cfg.num_experts,
          "splits_seen": sorted({str(s) for s in splits}),
          "loss_bits_equal": prints["plain"][0] == prints["expert_parallel"][0],
          "gradient_checksums_equal": prints["plain"][1] == prints["expert_parallel"][1],
          "leaves": len(prints["plain"][1]), "pass_s": secs,
          "launches_per_pass": passes, "expected_launches_per_pass": expected,
          "ok": same and splits == want_splits})
    if not same:
        raise SystemExit("spmd_train_moe: the expert-parallel pass differs from the plain one")
    if splits != want_splits:
        raise SystemExit(f"spmd_train_moe: the MoE FFN ran as {splits}, not {want_splits}")
    for name, got in passes.items():
        if got != expected:
            raise SystemExit(f"spmd_train_moe {name}: launches {got} != {expected}")
    del params
    torch.cuda.empty_cache()


def spmd_phases(train: dict) -> None:
    """Part 6, each phase's launches counted from zero where it checks them."""
    mesh = make_smoke_mesh(1, 1, "cuda")
    spmd_train(mesh, train)
    spmd_train_moe(mesh)
    spmd_serve(mesh)
    tp_plan()
    dryrun_phase()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main_mla() if sys.argv[1:] == ["mla"] else main()
