"""The port's profiler spans, on the CPU: ``serve.step`` and ``serve.admit``
in the serving engine, ``model.prefill``, ``model.decode`` and
``attention.decode`` in the model, and ``train.forward``,
``train.backward`` and ``train.optimizer`` in the train step, each once
where it belongs, beside the older ``attention``, ``moe_ffn`` and
``moe_experts``."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_config
from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.runtime.serving import Request, ServingEngine


def _spans(prof) -> dict[str, list[tuple[int, int]]]:
    out: dict[str, list[tuple[int, int]]] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            out.setdefault(ev.name(), []).append((ev.start_ns(), ev.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _within(spans, outers) -> list[list]:
    """For each outer span, the spans that lie inside it."""
    return [[s for s in spans if _inside(s, o)] for o in outers]


def _cfg(name):
    return dataclasses.replace(get_config(name).smoke(), compute_dtype="float32")


def test_engine_spans_a_step_its_admissions_and_its_tick():
    cfg = _cfg("yi-9b")
    eng = ServingEngine(cfg, init_params(lm.lm_param_specs(cfg), 0, "cpu"),
                        max_slots=2, max_seq=48)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=[1, 2, 3, 4 + rid], max_new_tokens=3))
    calls = 6  # two rounds of two ticks, then every slot idle and no queue
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        active = [eng.step() for _ in range(calls)]
    assert active == [2, 2, 2, 2, 0, 0]
    sp = _spans(prof)
    ticks = sum(a > 0 for a in active)
    assert len(sp["serve.step"]) == calls
    assert [len(a) for a in _within(sp["serve.admit"], sp["serve.step"])] == [1] * calls
    # each admission's prefill inside its step's serve.admit
    prefills = _within(sp["model.prefill"], sp["serve.admit"])
    assert sum(len(p) for p in prefills) == len(sp["model.prefill"]) == 4
    assert [len(p) for p in prefills] == [2, 0, 2, 0, 0, 0]
    # one model.decode a tick, inside its step and outside its admissions
    assert len(sp["model.decode"]) == ticks
    assert all(len(d) == 1 for d in _within(sp["model.decode"], sp["serve.step"])[:ticks])
    assert not any(_inside(d, a) for d in sp["model.decode"] for a in sp["serve.admit"])
    # num_layers attention.decode a tick, each inside an attention span
    per_tick = _within(sp["attention.decode"], sp["model.decode"])
    assert [len(a) for a in per_tick] == [cfg.num_layers] * ticks
    assert all(any(_inside(a, at) for at in sp["attention"]) for a in sp["attention.decode"])
    # attention: num_layers a prefill and a tick, as before
    assert len(sp["attention"]) == cfg.num_layers * (4 + ticks)
    assert not any(_inside(a, p) for a in sp["attention.decode"] for p in sp["model.prefill"])


@pytest.mark.parametrize("name", ["yi-9b", "olmoe-1b-7b"])
def test_train_step_spans_forward_backward_and_optimizer(name):
    cfg = _cfg(name)
    params = init_params(steps.model_param_specs(cfg), 0, "cpu")
    opt_cfg = adamw.AdamWConfig()
    opt_state = adamw.init_state(params, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg, warmup_steps=1, total_steps=4)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt_state, batch, 0)
    sp = _spans(prof)
    (fwd,), (bwd,), (opt,) = sp["train.forward"], sp["train.backward"], sp["train.optimizer"]
    assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]  # disjoint, in that order
    # the forward's attention spans, and the recompute's in the backward
    passes = 2 if cfg.remat else 1
    assert [len(a) for a in _within(sp["attention"], [fwd, bwd, opt])] == \
        [cfg.num_layers, cfg.num_layers * (passes - 1), 0]
    assert len(sp["attention"]) == cfg.num_layers * passes
    assert "attention.decode" not in sp and "model.decode" not in sp
    moe_layers = cfg.layer_counts().get("moe", 0)
    if not moe_layers:
        assert "moe_ffn" not in sp and "moe_experts" not in sp
        return
    assert [len(m) for m in _within(sp["moe_ffn"], [fwd, bwd, opt])] == \
        [moe_layers, moe_layers * (passes - 1), 0]
    assert [len(e) for e in _within(sp["moe_experts"], sp["moe_ffn"])] == \
        [1] * moe_layers * passes
