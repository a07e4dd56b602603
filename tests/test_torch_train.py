"""Training in the port against the JAX package, on the CPU.

* Trainer parity from one parameter tree: a JAX ``Trainer(num_steps=0)``
  writes step 0; a JAX trainer and the port's resume copies of it and take
  3 steps on the ``yi-9b``, ``recurrentgemma-2b``, ``olmoe-1b-7b``,
  ``xlstm-350m``, ``seamless-m4t-large-v2`` (frames) and ``internvl2-2b``
  (its ViT prefix) smoke configs in float32.  ``loss``, ``ce_loss``,
  ``grad_norm`` and the MoE aux values must agree within 1e-4 at every
  step (they agree to a few 1e-6: float32 sums in another order).  The
  same for yi-9b under ``remat_policy="dots"`` in both packages.
* The counterparts of ``tests/test_runtime.py``'s trainer and straggler
  cases, against the port's ``Trainer`` (the crash replay bit-identical).
* The counterpart of ``tests/test_archs.py::test_train_step_runs_and_is_finite``
  for every family the port runs.
* The training launcher's command line.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.registry import get_config as jax_get_config
from repro.runtime.executor import Trainer as JaxTrainer
from repro.runtime.executor import TrainerConfig as JaxTrainerConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.models.common import init_params
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.executor import Trainer, TrainerConfig
from repro_torch.runtime.failures import FailureEvent, FailurePlan, StragglerMonitor

PARITY_TOL = 1e-4
PORTED = ["yi-9b", "phi3-medium-14b", "command-r-35b", "gemma3-4b", "recurrentgemma-2b",
          "olmoe-1b-7b", "llama4-maverick-400b-a17b", "xlstm-350m", "internvl2-2b",
          "seamless-m4t-large-v2"]
MOE_AUX = {"moe_lb_loss", "moe_z_loss", "moe_drop_fraction"}
TINY = ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")


# -- parity with the JAX trainer ------------------------------------------------------


@pytest.mark.parametrize("name", ["yi-9b", "recurrentgemma-2b", "olmoe-1b-7b",
                                  "xlstm-350m", "seamless-m4t-large-v2",
                                  "internvl2-2b"])
def test_trainer_matches_the_jax_trainer_from_one_checkpoint(name, tmp_path):
    _trainer_parity(name, tmp_path)


def _trainer_parity(name, tmp_path, **overrides):
    """Both trainers take 3 steps from the JAX trainer's step-0 checkpoint
    of ``name``'s smoke config in float32 (with ``overrides``)."""
    over = dict(compute_dtype="float32", **overrides)
    jcfg = dataclasses.replace(jax_get_config(name).smoke(), **over)
    cfg = dataclasses.replace(get_config(name).smoke(), **over)
    jshape = JaxShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")
    JaxTrainer(jcfg, jshape, JaxTrainerConfig(
        num_steps=0, checkpoint_dir=str(tmp_path / "start"))).run()
    for d in ("jax", "port"):
        shutil.copytree(tmp_path / "start", tmp_path / d)
    kw = dict(num_steps=3, checkpoint_every=10, warmup_steps=2)
    jtr = JaxTrainer(jcfg, jshape, JaxTrainerConfig(
        checkpoint_dir=str(tmp_path / "jax"), **kw))
    jtr.run()
    tr = Trainer(cfg, TINY, TrainerConfig(checkpoint_dir=str(tmp_path / "port"), **kw),
                 device="cpu")
    assert tr.step0 == jtr.step0 == 0  # both restored the JAX checkpoint
    tr.run()
    assert [m["step"] for m in tr.metrics_history] == [0, 1, 2]
    for got, want in zip(tr.metrics_history, jtr.metrics_history, strict=True):
        assert set(got) == set(want)
        for key in ("loss", "ce_loss", "grad_norm", *sorted(MOE_AUX & set(want))):
            assert abs(got[key] - want[key]) <= PARITY_TOL, (key, got, want)
        assert np.float32(got["lr"]) == pytest.approx(np.float32(want["lr"]), rel=1e-6)


# -- the counterparts of tests/test_runtime.py ------------------------------------------


def _trainer(tmp, steps=10, failure_plan=None, resume=True):
    cfg = get_config("yi-9b").smoke()
    return Trainer(
        cfg, TINY,
        TrainerConfig(num_steps=steps, checkpoint_every=4, checkpoint_dir=tmp,
                      warmup_steps=2, resume=resume),
        opt_cfg=AdamWConfig(),
        failure_plan=failure_plan or FailurePlan(),
        device="cpu",
    )


def test_trainer_runs_and_checkpoints(tmp_path):
    tr = _trainer(str(tmp_path), steps=9)
    out = tr.run()
    assert out["final_step"] == 9
    assert out["restarts"] == 0
    assert tr.ckpt.latest_step() == 9
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_history)


def test_trainer_crash_restart_is_deterministic(tmp_path):
    """After an injected crash, restore + replay produce bit-identical
    losses for the replayed steps."""
    plan = FailurePlan([FailureEvent(step=6, kind="crash")])
    tr = _trainer(str(tmp_path), steps=10, failure_plan=plan)
    out = tr.run()
    assert out["restarts"] == 1
    by_step, replay_deltas = {}, []
    for m in tr.metrics_history:
        if m["step"] in by_step:
            replay_deltas.append(abs(by_step[m["step"]] - m["loss"]))
        by_step[m["step"]] = m["loss"]
    assert replay_deltas, "crash should force replayed steps"
    assert max(replay_deltas) == 0.0


def test_trainer_resume_across_instances(tmp_path):
    _trainer(str(tmp_path), steps=4).run()
    tr2 = _trainer(str(tmp_path), steps=8)
    assert tr2.step0 == 4  # picked up the checkpoint
    assert tr2.run()["final_step"] == 8


def test_restart_budget_exhaustion(tmp_path):
    plan = FailurePlan([FailureEvent(step=s, kind="crash") for s in (2, 2, 2, 2, 2, 2)])
    tr = _trainer(str(tmp_path), steps=6, failure_plan=plan)
    tr.cfg.max_restarts = 2
    with pytest.raises(RuntimeError, match="restart budget"):
        tr.run()


def test_straggler_monitor_detects():
    mon = StragglerMonitor(threshold=2.0)
    detected = [mon.record(0.1) for _ in range(10)]
    assert not any(detected)
    assert mon.record(0.5) is True
    assert mon.record(0.1) is False


def test_trainer_trains_under_dots_and_asks_for_the_cpu_without_a_card(
        tmp_path, monkeypatch):
    """Sharding, a mesh and elastic re-meshing are ported (they run in
    tests/test_torch_distributed.py); the JAX package's
    ``remat_policy="dots"`` trains as its trainer does, from one
    checkpoint; and without a card the trainer asks for ``device="cpu"``."""
    _trainer_parity("yi-9b", tmp_path, remat_policy="dots")
    cfg = get_config("yi-9b").smoke()
    tcfg = TrainerConfig(num_steps=1, checkpoint_dir=str(tmp_path / "card"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(cfg, TINY, tcfg)


# -- the counterpart of tests/test_archs.py ------------------------------------------------


@pytest.mark.parametrize("name", PORTED)
def test_train_step_runs_and_is_finite(name):
    cfg = dataclasses.replace(get_config(name).smoke(), compute_dtype="float32")
    params = init_params(steps_mod.model_param_specs(cfg), 0, "cpu")
    opt_cfg = AdamWConfig()
    opt_state = adamw.init_state(params, opt_cfg)
    step = steps_mod.make_train_step(cfg, opt_cfg, warmup_steps=1, total_steps=4)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32))
    elif cfg.frontend_len:
        batch["extra_embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    params, opt_state, metrics = step(params, opt_state, batch, 0)
    aux = MOE_AUX if "moe" in cfg.layer_pattern else set()
    assert set(metrics) == {"loss", "ce_loss", "grad_norm", "lr"} | aux
    assert torch.isfinite(metrics["loss"]), name
    assert 2.0 < float(metrics["ce_loss"]) < 12.0  # ~ln(vocab) at init
    assert torch.isfinite(metrics["grad_norm"])
    assert not any(leaf.requires_grad for leaf in adamw.tree_leaves(params))
    p0 = adamw.tree_leaves(params)[0].clone()
    params, opt_state, _m2 = step(params, opt_state, batch, 1)
    assert not torch.allclose(adamw.tree_leaves(params)[0], p0)
    assert int(opt_state["count"]) == 2


# -- the launcher ------------------------------------------------------------------------------


def test_train_launcher_runs_a_crash_and_restore(tmp_path, capsys):
    from repro_torch.launch import train

    out = train.main(["--arch", "recurrentgemma-2b", "--smoke", "--steps", "5",
                      "--batch", "2", "--seq", "32", "--crash-at", "3",
                      "--checkpoint-every", "2", "--checkpoint-dir", str(tmp_path),
                      "--device", "cpu"])
    assert out["final_step"] == 5 and out["restarts"] == 1
    text = capsys.readouterr().out
    assert "=== training finished ===" in text and "restarts: 1" in text
    assert train.main(["--arch", "yi-9b", "--plan"]) is None
    assert "DeploymentPlan" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-2b",
                                  "olmoe-1b-7b", "xlstm-350m"])
def test_train_launcher_takes_every_family(arch, tmp_path, capsys):
    """Frames for the encoder-decoder and the ViT prefix for internvl2 come
    from the data pipeline; the MoE aux values are among the metrics."""
    from repro_torch.launch import train

    out = train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                      "--seq", "16", "--checkpoint-dir", str(tmp_path),
                      "--device", "cpu"])
    assert out["final_step"] == 2 and out["restarts"] == 0
    metrics = out["last_metrics"]
    assert np.isfinite(metrics["loss"])
    assert ("moe_lb_loss" in metrics) == (arch == "olmoe-1b-7b")
    assert "=== training finished ===" in capsys.readouterr().out
