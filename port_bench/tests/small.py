"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same drivers, references and limits, at smoke widths and short traffic."""

from __future__ import annotations

import time
from pathlib import Path

from port_bench import cell as cell_mod

ROOT = Path(__file__).resolve().parents[2]


def small_cell(workload: str, config_of: str | None = None,
               **overrides) -> cell_mod.Cell:
    """``workload`` at smoke size; with ``config_of``, under the
    configuration (and reference) of that other workload; ``overrides``
    set keys of the configuration."""
    cell = cell_mod.resolve(ROOT, workload)
    if config_of is not None:
        other = cell_mod.resolve(ROOT, config_of)
        cell.config, cell.reference = other.config, other.reference
    cfg = dict(cell.config, num_layers=2, d_model=64, num_heads=4, head_dim=16,
               vocab_size=256)
    if cfg["family"] == "moe":
        cfg.update(num_kv_heads=4, num_experts=4, experts_per_token=2,
                   moe_d_ff=32, loss_seq_chunk=16)
    else:
        cfg.update(num_kv_heads=2, d_ff=128)
    cfg.update(overrides)
    mix = dict(cell.mix)
    if mix["kind"] == "train":
        mix.update(seq_len=64)
    else:
        mix.update(clients=4, slots=4, max_seq=64, round=4, checked_requests=3,
                   prompt=dict(mix["prompt"], median=8, min=4, max=16),
                   output=dict(mix["output"], min=8, max=16))
    cell.config, cell.mix = cfg, mix
    return cell


def small_run(workload: str, seed: int = 2**31 + 7, seconds: float = 0.5,
              fault: str | None = None, trace: bool = False,
              config_of: str | None = None, **overrides) -> cell_mod.Run:
    return cell_mod.Run(cell=small_cell(workload, config_of, **overrides), seed=seed,
                        seconds=seconds, trace=trace, t_start=time.perf_counter(),
                        device="cpu", fault=fault)
