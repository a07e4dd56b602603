"""Serving example: the paper's demand-driven client-server protocol as a
continuous-batching LLM engine (the JAX package's ``examples/serve_pipeline.py``).

Requests arrive in bursts; decode slots *request* work when idle; completed
sequences are collected and one is checked against offline greedy decode
(``prefill`` + ``decode_step``).

Run:  PYTHONPATH=src python -m repro_torch.serve_pipeline
      PYTHONPATH=src python -m repro_torch.serve_pipeline --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.runtime.serving import Request, ServingEngine

MAX_SEQ = 96


def offline_greedy(cfg, params, prompt: list[int], n_new: int, max_seq: int) -> list[int]:
    """``n_new`` greedy tokens through ``prefill`` + ``decode_step`` (batch 1)."""
    device = params["embed"].device
    logits, cache = lm.prefill(
        cfg, params, torch.tensor([prompt], device=device), max_seq)
    out = [int(torch.argmax(logits[0, 0, : cfg.vocab_size]))]
    clen = len(prompt)
    for _ in range(n_new - 1):
        lg, cache = lm.decode_step(
            cfg, params, cache, torch.tensor([[out[-1]]], device=device), clen)
        out.append(int(torch.argmax(lg[0, 0, : cfg.vocab_size])))
        clen += 1
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(get_config("gemma3-4b").smoke(),
                              compute_dtype="float32")
    params = init_params(lm.lm_param_specs(cfg), 0, device)
    engine = ServingEngine(cfg, params, max_slots=4, max_seq=MAX_SEQ)
    rng = np.random.default_rng(0)

    # Burst 1
    for rid in range(6):
        engine.submit(Request(
            rid=rid,
            prompt=list(map(int, rng.integers(0, cfg.vocab_size,
                                              int(rng.integers(4, 16))))),
            max_new_tokens=int(rng.integers(4, 12)),
        ))
    # run a few ticks, then a second burst joins mid-flight
    for _ in range(3):
        engine.step()
    for rid in range(6, 10):
        engine.submit(Request(
            rid=rid,
            prompt=list(map(int, rng.integers(0, cfg.vocab_size, 8))),
            max_new_tokens=6,
        ))
    t0 = time.perf_counter()
    done = engine.shutdown()
    dt = time.perf_counter() - t0

    n_tokens = sum(len(c.tokens) - c.prompt_len for c in done)
    print(f"served {len(done)} requests / {n_tokens} tokens "
          f"({n_tokens / max(dt, 1e-9):.1f} tok/s tail-phase) on {device}")
    # verify a sample against offline greedy decode
    c = sorted(done, key=lambda c: c.rid)[0]
    prompt, gen = c.tokens[: c.prompt_len], c.tokens[c.prompt_len:]
    if gen != offline_greedy(cfg, params, prompt, len(gen), MAX_SEQ):
        raise RuntimeError("continuous batching must match offline decode")
    print(f"request {c.rid}: engine output == offline greedy decode "
          f"({len(gen)} tokens)")
    print(engine.timing.report())
    return done


if __name__ == "__main__":
    main()
