"""Serving launcher: the demand-driven continuous-batching engine.

Example::

    python -m repro_torch.launch.serve --arch yi-9b --requests 16 --slots 4
    python -m repro_torch.launch.serve --arch yi-9b --device cpu   # no card

As the JAX package's launcher, it serves the arch's reduced ("smoke")
config with random parameters from ``--seed``.  It runs on the card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.runtime.serving import Request, ServingEngine


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()  # serving demo is CPU-sized
    params = init_params(lm.lm_param_specs(cfg), args.seed, device)
    engine = ServingEngine(cfg, params, max_slots=args.slots,
                           max_seq=args.max_seq)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        plen = int(rng.integers(4, 24))
        engine.submit(Request(
            rid=rid,
            prompt=list(map(int, rng.integers(0, cfg.vocab_size, plen))),
            max_new_tokens=args.max_new,
        ))
    done = engine.shutdown()
    dt = time.perf_counter() - t0
    n_tokens = sum(len(c.tokens) - c.prompt_len for c in done)
    print(f"=== served {len(done)} requests, {n_tokens} tokens "
          f"in {dt:.2f}s ({n_tokens / dt:.1f} tok/s) on {device} ===")
    lat = sorted(c.latency_s for c in done)
    print(f"latency p50 {lat[len(lat) // 2]:.3f}s  p99 {lat[-1]:.3f}s")
    print(engine.timing.report())
    return done


if __name__ == "__main__":
    main()
