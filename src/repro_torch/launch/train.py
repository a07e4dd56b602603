"""Training launcher: the fault-tolerant trainer on one device.

Examples::

    # reduced config + tiny shape, with checkpointing and fault tolerance:
    python -m repro_torch.launch.train --arch recurrentgemma-2b --smoke --steps 50

    # inject a crash at step 20 and watch the restore path:
    python -m repro_torch.launch.train --arch yi-9b --smoke --steps 40 --crash-at 20

    # print the deployment plan (HNL/NL bootstrap of the paper's fig. 1):
    python -m repro_torch.launch.train --arch yi-9b --plan

The flags are the JAX package's (``repro.launch.train``), plus ``--device``:
it runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.core.builder import ClusterBuilder
from repro_torch.core.dsl import ClusterSpec
from repro_torch.core.processes import EmitDetails, ResultDetails
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.executor import Trainer, TrainerConfig
from repro_torch.runtime.failures import FailureEvent, FailurePlan


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shape")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--crash-at", type=int, default=-1)
    ap.add_argument("--plan", action="store_true",
                    help="print the deployment plan and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))

    if args.plan:
        spec = ClusterSpec.simple(
            host="192.168.1.176", nclusters=16, workers_per_node=16,
            emit_details=EmitDetails(name="data", create=lambda s: (None, s)),
            work_function=lambda x: x,
            result_details=ResultDetails(name="metrics", collect=lambda a, x: a),
        )
        print(ClusterBuilder().deployment_plan(spec).describe())
        return None

    if args.smoke:
        shape = ShapeConfig("smoke", seq_len=args.seq,
                            global_batch=args.batch, kind="train")
    else:
        shape = get_shape(args.shape)

    plan = FailurePlan(
        [FailureEvent(step=args.crash_at, kind="crash")]
        if args.crash_at >= 0 else []
    )
    trainer = Trainer(
        cfg, shape,
        TrainerConfig(
            num_steps=args.steps,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            peak_lr=args.lr,
            warmup_steps=max(args.steps // 10, 1),
        ),
        opt_cfg=AdamWConfig(),
        failure_plan=plan,
        device=args.device,
    )
    out = trainer.run()
    print("=== training finished ===")
    print(f"final step: {out['final_step']}  restarts: {out['restarts']}")
    for k, v in out["last_metrics"].items():
        print(f"  {k}: {v:.6g}")
    print(out["timing"])
    return out


if __name__ == "__main__":
    main()
