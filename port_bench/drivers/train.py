"""Driver of a training mix: the program's ``make_train_step`` on seeded
batches, steps back to back.

Set-up makes the weights from the seed and one train step with its AdamW
state, and drives that same step through the mix's ``checked_steps``
first steps (distinct batches, the window's own call and feed), which also
warm up every shape.  From those steps it keeps what the check compares:
each step's loss, each leaf's first gradient as the optimizer took it
(its first moment over 1 - b1: its norm, and its values at a sample of
the leaf's elements drawn from the seed) and each leaf's change after
the last.
The window then runs the following steps, reading the loss on the host
every ``loss_every`` steps.  After the window the program's state is
freed and the plain reference runs the checked steps from the same
weights and batches.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time

import torch

from port_bench import checks, program, trace, traffic, weights

from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import steps

FAULTS = ("state_unchanged", "half_batch")
SAMPLE = 1 << 20  # elements of each leaf whose first gradient is compared


def _batch(run, step: int, device) -> dict:
    mix, cfg = run.cell.mix, run.cell.config
    raw = traffic.train_batch(run.seed, step, mix["batch"], mix["seq_len"],
                              cfg["vocab_size"])
    return {k: torch.from_numpy(v).long().to(device, non_blocking=True)
            for k, v in raw.items()}


def change_norms(params: dict, specs, seed: int, dtype, device) -> dict:
    """Each leaf's norm of (now - as made from the seed), in float32."""
    out = {}
    for path, spec in weights.spec_leaves(specs):
        start = weights.make_leaf(spec, seed, path, dtype, device)
        now = weights.tree_get(params, path)
        out[path] = float((now.float() - start.float()).norm())
        del start
    return out


def sample_indices(specs, seed: int, device) -> dict:
    """Each leaf's sampled elements: ``SAMPLE`` flat indices drawn from the
    seed, or all of a smaller leaf."""
    out = {}
    for path, spec in weights.spec_leaves(specs):
        n = math.prod(spec.shape)
        if n <= SAMPLE:
            out[path] = torch.arange(n, device=device)
            continue
        gen = torch.Generator(device)
        gen.manual_seed(weights.leaf_seed(seed, f"{path}#sample"))
        out[path] = torch.randint(0, n, (SAMPLE,), generator=gen, device=device)
    return out


def _no_update(apply_updates):
    def skip(params, grads, state, cfg, lr):
        return params, state, {"grad_norm": adamw.global_norm(grads), "lr": lr}
    return skip


def _half_batch(ce):
    def half(x, head, targets, **kw):
        n = x.shape[1] // 2
        return ce(x[:, :n], head, targets[:, :n], **kw)
    return half


def _fault(run):
    if run.fault == "state_unchanged":
        return program.patched(adamw, "apply_updates", _no_update)
    if run.fault == "half_batch":
        return program.patched(lm, "chunked_cross_entropy", _half_batch)
    if run.fault is not None:
        raise ValueError(f"no fault {run.fault!r} in a training cell")
    return contextlib.nullcontext()


def run(run) -> dict:
    mix, config = run.cell.mix, run.cell.config
    opt = mix["optimizer"]
    dev = torch.device(run.device)
    phases = {"start": time.perf_counter() - run.t_start}
    cfg = program.model_config(config)
    specs = program.param_specs(cfg)
    dtype = getattr(torch, config["param_dtype"])
    params = weights.make_tree(specs, run.seed, dtype, dev)
    opt_cfg = adamw.AdamWConfig(b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                                weight_decay=opt["weight_decay"],
                                clip_norm=opt["clip_norm"])
    opt_state = adamw.init_state(params, opt_cfg)
    train_step = steps.make_train_step(
        cfg, opt_cfg, peak_lr=opt["peak_lr"], warmup_steps=opt["warmup_steps"],
        total_steps=opt["total_steps"])
    checked = mix["checked_steps"]
    tokens_per_step = mix["batch"] * mix["seq_len"]
    sample = sample_indices(specs, run.seed, dev)
    _sync(dev)
    phases["state"] = time.perf_counter() - run.t_start

    with _fault(run):
        losses = []
        for i in range(checked):
            params, opt_state, metrics = train_step(params, opt_state,
                                                    _batch(run, i, dev), i)
            losses.append(metrics["loss"])
            if i == 0:
                moment = {path: weights.tree_get(opt_state["m"], path).float()
                          for path in sample}
                first_grad = {path: float(m.norm()) / (1 - opt["b1"])
                              for path, m in moment.items()}
                first_sample = {path: m.flatten()[sample[path]] / (1 - opt["b1"])
                                for path, m in moment.items()}
                del moment
            _sync(dev)
            phases[f"step{i}"] = time.perf_counter() - run.t_start
        prog = {"loss": [float(v) for v in losses], "grad": first_grad,
                "grad_sample": first_sample,
                "change": change_norms(params, specs, run.seed, dtype, dev)}

        counts: dict = {"batch": mix["batch"], "seq_len": mix["seq_len"],
                        "setup_phases_s": phases}
        launches0 = program.flash_launches()
        with trace.profiled(run.trace) as prof:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            with torch.profiler.record_function(trace.WINDOW_SPAN):
                t0 = time.perf_counter()
                setup_s = t0 - run.t_start
                phases["change"] = setup_s
                window_losses, step = [], checked
                while time.perf_counter() - t0 < run.seconds:
                    params, opt_state, metrics = train_step(
                        params, opt_state, _batch(run, step, dev), step)
                    window_losses.append(metrics["loss"])
                    step += 1
                    if len(window_losses) % mix["loss_every"] == 0:
                        float(window_losses[-1])
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
        counts["steps"] = len(window_losses)
        counts["window_s"] = t1 - t0
        counts["flash_backward_calls"] = (program.flash_launches()["backward"]
                                          - launches0["backward"])
        tr = trace.Trace(prof) if prof is not None else None
        del prof
        failed = int((~torch.isfinite(torch.stack(window_losses).float())).sum())

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del params, opt_state, train_step, metrics, losses, window_losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_readings(run, specs, dtype, dev, "f32", sample)
    numbers, by_leaf = compare(prog, ref)
    correct, compared = checks.judge(numbers, run.cell.limits)
    return {
        "correct": correct, "attempted": counts["steps"], "failed": failed,
        "metrics": {"train_tokens_per_s": counts["steps"] * tokens_per_step
                    / counts["window_s"], "setup_s": setup_s},
        "memory_peak_bytes": peak, "checks": compared, "trace": tr,
        "counts": counts, "readings": {"program": _plain(prog),
                                       "reference": _plain(ref), "by_leaf": by_leaf},
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reference_readings(run, specs, dtype, device, precision: str,
                       sample: dict) -> dict:
    """The plain reference's losses, first gradients (norms and sampled
    values) and changes over the checked steps, from the weights and
    batches the program had."""
    params = weights.make_tree(specs, run.seed, dtype, device)
    batches = [_batch(run, i, device) for i in range(run.cell.mix["checked_steps"])]
    out = run.cell.reference.train(run.cell.config, params, batches,
                                   run.cell.mix["optimizer"], precision, sample)
    out["change"] = change_norms(params, specs, run.seed, dtype, device)
    del params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def compare(prog: dict, ref: dict) -> tuple[dict, dict]:
    """The numbers compared: the worst step's loss gap, the worst leaf's
    first-gradient gap and the worst moving leaf's change gap (gaps of
    norms), and the median leaf's difference of the first gradient over its
    sampled elements, over the reference's; and that difference by leaf."""
    diff = {path: float((prog["grad_sample"][path] - r).norm() / r.norm().clamp(min=1e-30))
            for path, r in ref["grad_sample"].items()}
    numbers = {
        "loss_gap": max(checks.relative_gap(p, r)
                        for p, r in zip(prog["loss"], ref["loss"])),
        "grad_gap": checks.worst_leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": checks.worst_leaf_gap(prog["change"], ref["change"],
                                            checks.moving_leaves(ref["grad"])),
        "grad_diff": statistics.median(diff.values()),
    }
    return numbers, diff


def _plain(readings: dict) -> dict:
    """Readings without the sampled tensors."""
    return {k: v for k, v in readings.items() if k != "grad_sample"}


def control_numbers(run, precision: str) -> dict:
    """The control: the reference computed in ``precision`` put in the
    program's place, judged against the reference (and both sides'
    readings, under ``readings``)."""
    config = run.cell.config
    specs = program.param_specs(program.model_config(config))
    dtype = getattr(torch, config["param_dtype"])
    dev = torch.device(run.device)
    sample = sample_indices(specs, run.seed, dev)
    ref = reference_readings(run, specs, dtype, dev, "f32", sample)
    low = reference_readings(run, specs, dtype, dev, precision, sample)
    numbers, by_leaf = compare(low, ref)
    return {**numbers, "readings": {"control": _plain(low), "reference": _plain(ref),
                                    "by_leaf": by_leaf}}
