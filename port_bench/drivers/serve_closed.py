"""Driver of a closed-loop serving mix: ``clients`` callers of the
program's ``ServingEngine``, each sending its next request at the first
step boundary after its last one completed, with no think time.

Set-up makes the weights from the seed and the engine with ``slots``
slots of ``max_seq`` positions, and runs the loop until every request of
the first ``warmup_turnovers`` rounds of clients has completed: the cache
is full and every slot has turned over.  The window opens at a step
boundary and closes at the first boundary past ``--seconds``.

A request's time to first token runs from its submission to the end of
the ``step()`` that produced its first token (the prefill at admission):
the first moment a caller of the engine can see it.  Throughput counts
the prompt tokens prefilled and the tokens generated in the window.

The check: once the window has closed and the program's state is freed,
the plain reference runs over a sample of the requests completed in the
window, each prompt with its served tokens: the longest, those with the
most tokens decoded for their prompt's length (where a decode that loses
its own keys weighs most), and others drawn from the seed.  It reads by
how much each served token's logit lies below the reference's best at its
position, and how far the program's decode logits lie from the
reference's: every decode tick keeps its rows' logits at ``LOGIT_COLUMNS``
columns of the vocabulary drawn from the seed (one gather a tick, on the
device), with each row's request and position.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from port_bench import checks, program, trace, traffic, weights

from repro_torch.models import lm
from repro_torch.runtime.serving import Request, ServingEngine

FAULTS = ("state_unchanged", "token_altered")
ALTER_EVERY = 8  # the planted fault alters every row's token on every 8th tick
LOGIT_COLUMNS = 512  # vocabulary columns of every decoded row that the check keeps
BY_RATIO = 3  # sampled requests chosen for the most tokens decoded a prompt token


class ClosedLoop:
    """The clients' side of the engine."""

    def __init__(self, engine: ServingEngine, stream: traffic.RequestStream):
        self.engine, self.stream = engine, stream
        self.next_index = 0
        self.submitted: dict[int, float] = {}
        self.first: dict[int, float] = {}
        self.done: dict[int, float] = {}
        self.completion: dict[int, object] = {}
        self._waiting: set[int] = set()
        self._seen = 0

    def submit(self, now: float) -> None:
        j = self.next_index
        self.next_index += 1
        req = self.stream.request(j)
        self.engine.submit(Request(rid=j, prompt=req.prompt,
                                   max_new_tokens=req.max_new_tokens))
        self.submitted[j] = now
        self._waiting.add(j)

    def boundary(self, now: float) -> None:
        """Each client whose request completed sends its next one."""
        new = self.engine.completions[self._seen:]
        self._seen += len(new)
        for c in new:
            self.done[c.rid] = now
            self.completion[c.rid] = c
            self.submit(now)

    def step(self) -> tuple[int, list[int]]:
        """One engine step: (slots that decoded, requests admitted)."""
        active = self.engine.step()
        now = time.perf_counter()
        queued = {r.rid for r in self.engine.queue}
        admitted = sorted(j for j in self._waiting if j not in queued)
        for j in admitted:
            self.first[j] = now
            self._waiting.discard(j)
        return active, admitted


def _kept_logits(engine: ServingEngine, columns: torch.Tensor, log: list):
    """A wrapper of ``decode_step`` that keeps, after each call, the rows'
    logits at ``columns`` with each row's request and position (the
    engine's state before it takes the tick's tokens)."""
    def wrap(decode_step):
        def kept(*args, **kwargs):
            logits, cache = decode_step(*args, **kwargs)
            log.append((engine.slot_rid.copy(), engine.lens.copy(),
                        logits[:, 0, columns]))
            return logits, cache
        return kept
    return wrap


def logit_columns(seed: int, vocab: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed % 2**63)
    cols = torch.randperm(vocab, generator=gen)[:LOGIT_COLUMNS]
    return cols.sort().values.to(device)


def _keep_cache(write_kv):
    def skip(c, new, slot, cache_len):
        return c
    return skip


def _alter_tokens(vocab: int):
    def wrap(decode_step):
        calls = [0]

        def altered(*args, **kwargs):
            logits, cache = decode_step(*args, **kwargs)
            calls[0] += 1
            if calls[0] % ALTER_EVERY == 0:
                row = logits[:, 0, :vocab]
                alt = (row.argmax(-1) + 1) % vocab
                rows = torch.arange(row.shape[0], device=row.device)
                logits[rows, 0, alt] = row.max(-1).values + 1
            return logits, cache
        return altered
    return wrap


def _fault(run, vocab: int):
    if run.fault == "state_unchanged":
        return program.patched(lm, "_write_kv", _keep_cache)
    if run.fault == "token_altered":
        return program.patched(lm, "decode_step", _alter_tokens(vocab))
    if run.fault is not None:
        raise ValueError(f"no fault {run.fault!r} in a serving cell")
    return contextlib.nullcontext()


def run(run) -> dict:
    mix, config = run.cell.mix, run.cell.config
    dev = torch.device(run.device)
    phases = {"start": time.perf_counter() - run.t_start}
    cfg = program.model_config(config)
    specs = program.param_specs(cfg)
    dtype = getattr(torch, config["param_dtype"])
    params = weights.make_tree(specs, run.seed, dtype, dev)
    _sync(dev)
    phases["weights"] = time.perf_counter() - run.t_start
    engine = ServingEngine(cfg, params, max_slots=mix["slots"], max_seq=mix["max_seq"])
    _sync(dev)
    phases["engine"] = time.perf_counter() - run.t_start
    stream = traffic.RequestStream(mix, run.seed, config["vocab_size"])
    loop = ClosedLoop(engine, stream)
    prefill_lens: list[int] = []
    decodes: list[tuple[int, int]] = []  # (slots decoding, their contexts)
    decoded: list = []  # (slot requests, slot positions, logits at the columns)
    columns = logit_columns(run.seed, config["vocab_size"], dev)

    def on_prefill(cfg_, params_, tokens, *a, **k):
        if len(prefill_lens) == 1:  # the first (it ends in a read of its token)
            phases["first_prefill"] = time.perf_counter() - run.t_start
        prefill_lens.append(int(tokens.shape[1]))

    def on_decode(*a, **k):
        active = engine.slot_rid >= 0
        decodes.append((int(active.sum()), int((engine.lens[active] + 1).sum())))

    with contextlib.ExitStack() as patches:
        patches.enter_context(program.patched(
            lm, "prefill", program.spanned("bench.prefill", on_prefill)))
        patches.enter_context(program.patched(
            lm, "decode_step", program.spanned("bench.decode", on_decode)))
        patches.enter_context(_fault(run, config["vocab_size"]))
        patches.enter_context(program.patched(
            lm, "decode_step", _kept_logits(engine, columns, decoded)))

        for _ in range(mix["clients"]):
            loop.submit(time.perf_counter())
        warm = mix["clients"] * mix["warmup_turnovers"]
        first_turnover = None
        while any(j not in loop.done for j in range(warm)):
            loop.boundary(time.perf_counter())
            loop.step()
            if first_turnover is None and not loop._waiting:
                first_turnover = time.perf_counter() - run.t_start
        phases["first_admitted"] = first_turnover

        launches0 = program.flash_launches()["forward"]
        host_ms0 = engine.timing.node("host").run_ms
        first_prefill, first_decode = len(prefill_lens), len(decodes)
        tokens = ticks = 0
        with trace.profiled(run.trace) as prof:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            with torch.profiler.record_function(trace.WINDOW_SPAN):
                t0 = time.perf_counter()
                setup_s = t0 - run.t_start
                phases["warm"] = setup_s
                while True:
                    now = time.perf_counter()
                    if now - t0 >= run.seconds:
                        break
                    loop.boundary(now)
                    active, admitted = loop.step()
                    ticks += active > 0
                    tokens += active + sum(1 + stream.lengths(j)[0] for j in admitted)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
        counts = {
            "window_s": t1 - t0, "ticks": ticks,
            "tick_host_ms": engine.timing.node("host").run_ms - host_ms0,
            "prefill_lens": prefill_lens[first_prefill:],
            "decodes": decodes[first_decode:],
            "flash_forward_calls": program.flash_launches()["forward"] - launches0,
            "setup_phases_s": phases,
        }
        tr = trace.Trace(prof) if prof is not None else None
        del prof

    in_window = [j for j, t in loop.submitted.items() if t >= t0]
    ttft = [(loop.first[j] - loop.submitted[j]) * 1e3 for j in in_window
            if j in loop.first]
    counts["ttft_ms"] = ttft
    finished = sorted(j for j, t in loop.done.items() if t0 <= t <= t1)
    samples = _sample(run, loop, stream, finished, mix["checked_requests"], decoded)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, loop, params, decoded
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    gaps, errors = reference_readings(run, specs, dtype, dev, samples, columns)
    numbers = {"served_gap": max(gaps, default=float("inf")),
               "decode_logit_err": max(errors, default=float("inf")),
               "served_mismatch": float(sum(s["mismatch"] for s in samples))}
    correct, compared = checks.judge(numbers, run.cell.limits)
    return {
        "correct": correct, "attempted": len(in_window),
        "failed": len(in_window) - len(ttft),
        "metrics": {"serve_tokens_per_s": tokens / counts["window_s"],
                    "setup_s": setup_s},
        "memory_peak_bytes": peak, "checks": compared, "trace": tr,
        "counts": counts,
        "readings": {"gaps": gaps, "errors": errors, "samples": samples,
                     "columns": columns, "finished": len(finished)},
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _sample(run, loop, stream, finished: list[int], n: int, decoded: list) -> list[dict]:
    """``n`` requests finished in the window: the longest, the ``BY_RATIO``
    with the most tokens served a prompt token, and others drawn from the
    seed.  Each with its prompt as sent, its tokens as served, its
    decode logits at the kept columns as the program computed them (row
    ``r`` of ``decoded`` produced served token ``r``), and whether the
    engine served what was asked (the whole prompt, ``max_new_tokens``
    tokens)."""
    if not finished:
        return []

    def served(j):
        c = loop.completion[j]
        return len(c.tokens) - c.prompt_len

    picked = [max(finished, key=lambda j: (len(loop.completion[j].tokens), -j))]
    by_ratio = sorted(finished, key=lambda j: (-served(j) / loop.completion[j].prompt_len, j))
    picked += [j for j in by_ratio if j not in picked][:min(BY_RATIO, n - 1)]
    rest = [j for j in finished if j not in picked]
    gen = np.random.Generator(np.random.Philox(key=run.seed % 2**64))
    picked += [rest[i] for i in sorted(
        gen.choice(len(rest), size=max(min(n - len(picked), len(rest)), 0),
                   replace=False))]
    wanted = set(picked)
    rows: dict[int, dict[int, torch.Tensor]] = {j: {} for j in picked}
    for rids, lens, logits in decoded:
        for slot in np.flatnonzero(np.isin(rids, list(wanted))):
            j = int(rids[slot])
            rows[j][int(lens[slot]) - loop.completion[j].prompt_len + 1] = logits[slot]
    out = []
    for j in picked:
        req, c = stream.request(j), loop.completion[j]
        tokens = c.tokens[c.prompt_len:]
        mismatch = (c.tokens[:c.prompt_len] != req.prompt
                    or len(tokens) != req.max_new_tokens)
        order = sorted(rows[j])
        out.append({"index": j, "prompt": req.prompt, "served": tokens,
                    "mismatch": int(mismatch), "decoded_at": order,
                    "decoded": (torch.stack([rows[j][r] for r in order]).float().cpu()
                                if order else None)})
    return out


def reference_logits(run, params, sample: dict, precision: str) -> torch.Tensor:
    """The reference's logits at every position that produced a served
    token: [served, vocab]."""
    seq = sample["prompt"] + sample["served"][:-1]
    tokens = torch.tensor([seq], dtype=torch.long, device=params["embed"].device)
    first = len(sample["prompt"]) - 1
    positions = torch.arange(first, len(seq), device=tokens.device)
    return run.cell.reference.logits_at(run.cell.config, params, tokens,
                                        positions, precision)


def gaps_below_best(logits: torch.Tensor, chosen) -> float:
    """The widest gap by which a chosen token's logit lies below the best
    at its position."""
    chosen = torch.as_tensor(chosen, device=logits.device)
    picked = logits.gather(1, chosen[:, None])[:, 0]
    return float((logits.max(-1).values - picked).max())


def logit_error(decoded: torch.Tensor | None, at: list[int], ref: torch.Tensor,
                columns: torch.Tensor) -> float:
    """The widest relative error of decode logits against the reference's
    at the kept columns: over the decoded positions, |decoded - ref| over
    |ref|, each a vector of the columns.  ``decoded`` rows are the served
    tokens ``at``; a request that decoded nothing reads 0."""
    if decoded is None:
        return 0.0
    want = ref[torch.as_tensor(at, device=ref.device)][:, columns.to(ref.device)]
    diff = decoded.to(ref.device) - want
    return float((diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max())


def reference_readings(run, specs, dtype, device, samples: list[dict],
                       columns: torch.Tensor) -> tuple[list[float], list[float]]:
    """Each sampled request's widest gap of a served token below the
    reference's best, and its widest relative error of decode logits, from
    weights made again from the seed."""
    params = weights.make_tree(specs, run.seed, dtype, device)
    gaps, errors = [], []
    for s in samples:
        ref = reference_logits(run, params, s, "f32")
        gaps.append(gaps_below_best(ref, s["served"]))
        errors.append(logit_error(s["decoded"], s["decoded_at"], ref, columns))
    del params
    return gaps, errors


def control_numbers(run, precision: str) -> dict:
    """The control on the requests of one run of the cell: at each position
    of the same prompts and served tokens, the gap below the reference's
    best of the token that the reference computed in ``precision`` puts
    first, and that reference's relative error of logits at the kept
    columns and decoded positions."""
    out = run.cell.driver.run(run)
    samples, columns = out["readings"]["samples"], out["readings"]["columns"]
    config = run.cell.config
    specs = program.param_specs(program.model_config(config))
    dtype = getattr(torch, config["param_dtype"])
    params = weights.make_tree(specs, run.seed, dtype, torch.device(run.device))
    gaps, errors = [], []
    for s in samples:
        ref = reference_logits(run, params, s, "f32")
        low = reference_logits(run, params, s, precision)
        gaps.append(gaps_below_best(ref, low.argmax(-1)))
        at = s["decoded_at"]
        errors.append(logit_error(low[at][:, columns.to(low.device)] if at else None,
                                  at, ref, columns))
    del params
    return {"served_gap": max(gaps), "decode_logit_err": max(errors),
            "served_mismatch": 0.0,
            "readings": {"gaps": gaps, "errors": errors,
                         "program": {k: v["value"] for k, v in out["checks"].items()}}}
