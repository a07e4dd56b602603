"""Continuous-batching serving engine built on the paper's protocol.

The mapping is direct (the JAX package's ``runtime/serving.py``):

    Emit      -> the request queue (`submit`)
    onrl      -> the slot scheduler: it answers an idle slot's *request* with
                 the next queued prompt (demand-driven; the server is never
                 blocked by a busy slot — the paper's liveness invariant)
    nrfa/work -> decode slots: a slot only requests new work after it has
                 delivered its finished sequence (one-place buffer invariant)
    afoc/afo  -> the completion merge
    Collect   -> finished-sequence results (`collect`)
    UT        -> `shutdown()`: drains slots, then the engine terminates

Decode is *batched across slots* (one ``decode_step`` call per engine tick,
per-slot cache lengths): new requests join on any tick without waiting for
others to finish.  The engine runs on the device its parameters lie on.
A prefill's cache is spliced into the engine's cache in place, and decode
writes each slot's new K/V into it in place.  With ``rules`` the parameters
are DTensors, the engine's cache is placed by the rules, prefill and decode
run under DTensor dispatch, and each rank splices the rows of its shard.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.core.timing import TimingCollector
from repro_torch.kernels._shard import whole
from repro_torch.models import lm as lm_mod


def _splice(full: torch.Tensor, slot: int, one: torch.Tensor) -> None:
    """Write a batch-1 prefill leaf ``one`` [n, 1, ...] into row ``slot`` of
    the engine's stacked cache leaf ``full`` [n, B, ...], in place.  A
    DTensor cache is written on its local shard: the rank that holds the
    slot's row writes its part of the leaf."""
    if not hasattr(full, "to_local"):
        full[:, slot] = one[:, 0]
        return
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        full.shape, full.device_mesh, full.placements)
    if not offset[1] <= slot < offset[1] + shape[1]:
        return
    rest = tuple(slice(o, o + n) for o, n in zip(offset[2:], shape[2:]))
    src = one[(slice(offset[0], offset[0] + shape[0]), 0) + rest]
    full.to_local()[:, slot - offset[1]] = src


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16


@dataclass
class Completion:
    """A finished request.  Its times run from its ``submit()``: to its
    admission (``queued_s``), to its first token on the host (``ttft_s``)
    and to its last (``latency_s``)."""

    rid: int
    tokens: list[int]
    prompt_len: int
    latency_s: float
    queued_s: float
    ttft_s: float


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        max_slots: int = 4,
        max_seq: int = 256,
        tp: int = 1,
        rules=None,
        eos_id: int | None = None,
    ):
        if cfg.encoder_layers:
            raise NotImplementedError("serving engine targets decoder-only LMs")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.tp = tp
        self.rules = rules
        self.eos_id = eos_id
        self.timing = TimingCollector()

        with self.timing.phase("host", "load"):
            self.cache = lm_mod.init_cache(cfg, max_slots, max_seq, tp,
                                           device=self.device, rules=rules)
            self.lens = np.zeros(max_slots, np.int64)  # tokens in cache
            self.remaining = np.zeros(max_slots, np.int64)
            self.slot_rid = np.full(max_slots, -1, np.int64)
            self.slot_tokens: list[list[int]] = [[] for _ in range(max_slots)]
            self.slot_prompt_len = np.zeros(max_slots, np.int64)
            self.slot_submitted = np.zeros(max_slots, np.float64)
            self.slot_queued_s = np.zeros(max_slots, np.float64)
            self.slot_ttft_s = np.zeros(max_slots, np.float64)
            self.last_token = np.zeros(max_slots, np.int64)

            self.queue: deque[Request] = deque()  # Emit -> onrl
            self._submitted: deque[float] = deque()  # each queued request's submit()
            self.completions: list[Completion] = []  # Collect
            self._shutdown = False

    # -- Emit side -------------------------------------------------------------

    def submit(self, request: Request) -> None:
        if self._shutdown:
            raise RuntimeError("engine is shut down (UT already propagated)")
        self.queue.append(request)
        self._submitted.append(time.perf_counter())

    # -- onrl: answer idle slots' requests with queued work ---------------------

    def _admit(self) -> None:
        """Every admission's prompt upload, prefill, splice and first-token
        read: the profiler span ``serve.admit``."""
        with record_function("serve.admit"):
            for slot in range(self.max_slots):
                if self.slot_rid[slot] >= 0 or not self.queue:
                    continue  # busy slot never blocks the server
                req = self.queue.popleft()
                submitted = self._submitted.popleft()
                prompt = req.prompt[: self.max_seq - req.max_new_tokens - 1]
                # Prefill this slot (batch=1) and splice its state into the
                # engine cache at the slot index.  The prefill logits give the
                # FIRST generated token; subsequent ticks feed it back.
                admitted = time.perf_counter()
                logits, pref_cache = lm_mod.prefill(
                    self.cfg, self.params,
                    torch.tensor([prompt], dtype=torch.int64, device=self.device),
                    self.max_seq, tp=self.tp, rules=self.rules,
                )
                for kind, leaves in pref_cache.items():
                    for name, one in leaves.items():
                        _splice(self.cache[kind][name], slot, one)
                first = int(torch.argmax(whole(logits)[0, 0, : self.cfg.vocab_size]))
                self.slot_rid[slot] = req.rid
                self.slot_tokens[slot] = list(prompt) + [first]
                self.slot_prompt_len[slot] = len(prompt)
                self.lens[slot] = len(prompt)
                self.remaining[slot] = req.max_new_tokens - 1
                self.last_token[slot] = first
                self.slot_submitted[slot] = submitted
                self.slot_queued_s[slot] = admitted - submitted
                self.slot_ttft_s[slot] = time.perf_counter() - submitted
                self.timing.count_item(f"slot{slot}")
                if self.remaining[slot] <= 0 or (
                    self.eos_id is not None and first == self.eos_id
                ):
                    self._complete(slot)

    # -- decode tick -------------------------------------------------------------

    def step(self) -> int:
        """One engine tick: admissions, then one decode of every slot (the
        profiler span ``serve.step``).  Returns the number of active slots."""
        with record_function("serve.step"):
            self._admit()
            active = self.slot_rid >= 0
            if not active.any():
                return 0
            t0 = time.perf_counter()
            # Note: idle slots decode garbage in lockstep (masked out below) —
            # the price of batched decode; their cache writes land at their
            # stale lens and are overwritten on admission (prefill).
            tokens = torch.tensor(self.last_token[:, None], device=self.device)
            lens = torch.tensor(self.lens, device=self.device)
            logits, self.cache = lm_mod.decode_step(
                self.cfg, self.params, self.cache, tokens, lens, tp=self.tp,
                rules=self.rules)
            next_tokens = torch.argmax(
                whole(logits)[:, 0, : self.cfg.vocab_size], dim=-1).cpu().numpy()
            self.timing.add("host", "run", (time.perf_counter() - t0) * 1e3)

            for slot in range(self.max_slots):
                if not active[slot]:
                    continue
                tok = int(next_tokens[slot])
                self.slot_tokens[slot].append(tok)
                self.lens[slot] += 1  # last_token is now in the cache
                self.remaining[slot] -= 1
                self.last_token[slot] = tok
                done = (
                    self.remaining[slot] <= 0
                    or (self.eos_id is not None and tok == self.eos_id)
                    or self.lens[slot] >= self.max_seq - 1
                )
                if done:
                    self._complete(slot)
            return int(active.sum())

    def _complete(self, slot: int) -> None:
        """afoc/afo -> Collect; the slot goes idle and (demand-driven)
        requests new work on the next tick."""
        self.completions.append(
            Completion(
                rid=int(self.slot_rid[slot]),
                tokens=list(self.slot_tokens[slot]),
                prompt_len=int(self.slot_prompt_len[slot]),
                latency_s=time.perf_counter() - self.slot_submitted[slot],
                queued_s=float(self.slot_queued_s[slot]),
                ttft_s=float(self.slot_ttft_s[slot]),
            )
        )
        self.slot_rid[slot] = -1
        self.slot_tokens[slot] = []

    # -- UT ------------------------------------------------------------------------

    def shutdown(self) -> list[Completion]:
        """Propagate the terminator: no new work, drain, return results."""
        self._shutdown = True
        guard = 0
        while (self.slot_rid >= 0).any() or self.queue:
            self.step()
            guard += 1
            if guard > 100000:  # pragma: no cover
                raise RuntimeError("drain did not terminate")
        return self.completions

    def run_until_drained(self) -> list[Completion]:
        """Step until the queue is empty and no slot is active; the engine
        stays open for more requests.  Returns every completion so far."""
        while self.queue or (self.slot_rid >= 0).any():
            self.step()
        return self.completions
