"""End-to-end training run (the port's counterpart of the JAX package's
``examples/train_lm.py``): train a small dense LM through the full stack
(data pipeline -> fault-tolerant trainer -> checkpoints) with a crash
injected mid-run to show the restore, and check that the loss falls.

    python -m repro_torch.train_lm [--full] [--steps N] [--device cpu]

The default is a ~10M-parameter model for 60 steps; ``--full`` runs the
~100M / 300-step variant.  It runs on the card unless ``--device`` names
another device.
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.executor import Trainer, TrainerConfig
from repro_torch.runtime.failures import FailureEvent, FailurePlan


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="lm-100m", family="dense", num_layers=8, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
        head_dim=64, attn_q_chunk=256, loss_seq_chunk=256,
    )


def model_10m() -> ModelConfig:
    return ModelConfig(
        name="lm-10m", family="dense", num_layers=4, d_model=256,
        num_heads=8, num_kv_heads=4, d_ff=1024, vocab_size=8192,
        head_dim=32, attn_q_chunk=128, loss_seq_chunk=128,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = model_100m() if args.full else model_10m()
    steps = args.steps or (300 if args.full else 60)
    shape = ShapeConfig("train", seq_len=512 if args.full else 256,
                        global_batch=8 if args.full else 4, kind="train")
    specs = steps_mod.model_param_specs(cfg)
    embed = sum(count_params(specs[k]) for k in ("embed", "lm_head") if k in specs)
    print(f"model: {cfg.name} ({(count_params(specs) - embed) / 1e6:.1f}M "
          f"non-embedding params), {steps} steps of "
          f"{shape.global_batch}x{shape.seq_len}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            cfg, shape,
            TrainerConfig(num_steps=steps, checkpoint_every=max(steps // 5, 1),
                          checkpoint_dir=ckpt_dir,
                          warmup_steps=max(steps // 10, 1), peak_lr=1e-3),
            opt_cfg=AdamWConfig(),
            failure_plan=FailurePlan(
                [FailureEvent(step=steps // 2, kind="crash")]),
            device=args.device,
        )
        out = trainer.run()
    losses = [m["ce_loss"] for m in trainer.metrics_history]
    print(f"\nfinished at step {out['final_step']} (restarts: {out['restarts']})")
    k = max(len(losses) // 10, 1)
    first = sum(losses[:k]) / k
    last = sum(losses[-k:]) / k
    print(f"ce_loss: first-{k} avg {first:.4f} -> last-{k} avg {last:.4f}")
    if not last < first:
        raise SystemExit("the loss did not decrease on the synthetic stream")
    print(out["timing"])
    return {"first": first, "last": last, **out}


if __name__ == "__main__":
    main()
