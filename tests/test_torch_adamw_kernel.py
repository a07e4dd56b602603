"""AdamW's one-pass kernel on the CPU: its arithmetic (``ref.adamw_update_one_pass``,
the kernel's order with its host-rounded constants) against the plain loop
bit for bit, the constants against PyTorch's rounding of a Python scalar,
and the paths a leaf takes.  The kernel itself is held to the loop on the
card by ``chip_smoke.py``'s ``adamw`` phase."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.adamw import kernel, ops, ref
from repro_torch.models.common import init_params
from repro_torch.optim import adamw
from repro_torch.runtime import steps

SIZES = (1, 7, 4099, (1 << 16) + 3)
DTYPES = (torch.float32, torch.bfloat16)
STEPS = 3


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def step_scalars(grads: dict, cfg: adamw.AdamWConfig, count: int):
    """(scale, b1c, b2c, lr) as ``apply_updates`` makes them."""
    gnorm = adamw.global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32)
    countf = torch.tensor(count, dtype=torch.int32).float()
    return (scale, 1.0 - torch.pow(cfg.b1, countf), 1.0 - torch.pow(cfg.b2, countf),
            torch.tensor(3e-4 * count, dtype=torch.float32))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("clip", [1.0, 0.0, 1e3])
@pytest.mark.parametrize("param_dtype", DTYPES, ids=["p32", "p16"])
@pytest.mark.parametrize("state_dtype", DTYPES, ids=["s32", "s16"])
def test_one_pass_equals_the_loop(size, clip, param_dtype, state_dtype):
    cfg = adamw.AdamWConfig(clip_norm=clip)
    consts = kernel.host_constants(cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
    rng = np.random.default_rng(size)
    p = torch.from_numpy(rng.standard_normal(size, dtype=np.float32)).to(param_dtype)
    m = torch.zeros(size, dtype=state_dtype)
    v = torch.zeros(size, dtype=state_dtype)
    for count in range(1, STEPS + 1):
        # gradients of both signs, a few large and a few tiny
        g = rng.standard_normal(size, dtype=np.float32) * np.float32(10.0 ** (count - 2))
        g[::5] *= np.float32(1e-20)
        g = torch.from_numpy(g).to(param_dtype)
        scale, b1c, b2c, lr = step_scalars({"g": g}, cfg, count)
        want = ref.adamw_update_one_pass(p, g, m, v, scale, b1c, b2c, lr, consts)
        ref.adamw_update_reference(p, g, m, v, scale, b1c, b2c, lr, cfg.b1, cfg.b2,
                                   cfg.eps, cfg.weight_decay)
        for name, got, w in zip("pmv", (p, m, v), want):
            assert got.dtype == w.dtype
            assert torch.equal(bits(got), bits(w)), (name, count)


@pytest.mark.parametrize("hyper", [
    (0.9, 0.95, 1e-8, 0.1),  # AdamWConfig's defaults
    (0.9, 0.999, 1e-6, 0.01),
    (0.85, 0.98, 1e-12, 0.0),
    (1 - 1e-9, 1 / 3, 3e-45, 1e-40),  # 1 - b1 off the f32 grid; denormals
])
def test_host_constants_round_as_torch(hyper):
    b1, b2, eps, wd = hyper
    got = kernel.host_constants(b1, b2, eps, wd)
    for c, k in zip((b1, 1 - b1, b2, 1 - b2, eps, wd), got):
        assert k == torch.tensor(c, dtype=torch.float32).item(), c
        assert np.float32(k) == k  # a float32 value, held in a Python float


def _tree(seed: int, dtype=torch.float32) -> dict:
    rng = np.random.default_rng(seed)
    leaf = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)  # noqa: E731
    return {"a": leaf(7, 5), "b": {"c": leaf(4099), "d": leaf(3, 1, 2)}}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_cpu_leaf_takes_the_loop(monkeypatch, state_dtype):
    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU leaf reached the kernel")

    monkeypatch.setattr(kernel, "adamw_update_cuda", no_kernel)
    monkeypatch.setattr(ops, "adamw_update_cuda", no_kernel)
    cfg = adamw.AdamWConfig(state_dtype=state_dtype)
    params, grads = _tree(0), _tree(1)
    state = adamw.init_state(params, cfg)
    plain = adamw.tree_map(torch.clone, params)
    pm, pv = adamw.tree_map(torch.clone, state["m"]), adamw.tree_map(torch.clone, state["v"])
    assert kernel.LAUNCHES == 0
    for count in (1, 2):
        params, state, metrics = adamw.apply_updates(params, grads, state, cfg,
                                                     torch.tensor(1e-3))
        scale, b1c, b2c, _lr = step_scalars(grads, cfg, count)
        for p, g, m, v in zip(*(adamw.tree_leaves(t) for t in (plain, grads, pm, pv))):
            ref.adamw_update_reference(p, g, m, v, scale, b1c, b2c, torch.tensor(1e-3),
                                       cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
        assert int(state["count"]) == count
    assert kernel.LAUNCHES == 0
    leaves = lambda *trees: [x for t in trees for x in adamw.tree_leaves(t)]  # noqa: E731
    for got, want in zip(leaves(params, state["m"], state["v"]), leaves(plain, pm, pv)):
        assert torch.equal(bits(got), bits(want))


def test_a_meta_leaf_launches_nothing():
    """A trace's leaf (meta here, fake CUDA tensors in the dry-run) passes
    through the custom op's fake impl: shapes only, no launch."""
    t = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    ops.adamw_update(t(5, 3), t(5, 3), t(5, 3), t(5, 3), t(), t(), t(), t(),
                     0.9, 0.95, 1e-8, 0.1)
    assert kernel.LAUNCHES == 0


@pytest.mark.parametrize("bad", ["cpu", "grad_dtype", "state_dtypes", "size",
                                 "scalar_dtype", "strided"])
def test_kernel_wrapper_refuses_before_building(bad):
    f32 = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype)  # noqa: E731
    args = [f32(8), f32(8), f32(8), f32(8), f32(), f32(), f32(), f32()]
    if bad == "grad_dtype":
        args[1] = f32(8, dtype=torch.bfloat16)
    elif bad == "state_dtypes":
        args[3] = f32(8, dtype=torch.bfloat16)
    elif bad == "size":
        args[2] = f32(9)
    elif bad == "scalar_dtype":
        args[7] = f32(dtype=torch.float64)
    elif bad == "strided":
        args[0] = f32(16)[::2]
    with pytest.raises(ValueError):
        kernel.adamw_update_cuda(*args, kernel.host_constants(0.9, 0.95, 1e-8, 0.1))


def test_train_step_calls_apply_updates_through_the_module(monkeypatch):
    """``make_train_step`` looks ``adamw.apply_updates`` up at each call
    (the benchmark's ``state_unchanged`` control patches it there)."""
    cfg = dataclasses.replace(get_config("yi-9b").smoke(), num_layers=1)
    params = init_params(steps.model_param_specs(cfg), 0, "cpu")
    opt_cfg = adamw.AdamWConfig()
    opt_state = adamw.init_state(params, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg, warmup_steps=1, total_steps=4)
    calls = []

    def stand_in(params, grads, state, cfg, lr):
        calls.append(len(adamw.tree_leaves(grads)))
        return params, state, {"grad_norm": adamw.global_norm(grads), "lr": lr}

    before = adamw.tree_map(torch.clone, params)
    monkeypatch.setattr(adamw, "apply_updates", stand_in)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    step(params, opt_state, {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}, 0)
    assert calls == [len(adamw.tree_leaves(params))]
    assert all(torch.equal(a, b) for a, b in zip(adamw.tree_leaves(params),
                                                  adamw.tree_leaves(before)))
