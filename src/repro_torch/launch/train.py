"""Training driver: ``python -m repro_torch.launch.train --arch smollm-135m ...``

The port's counterpart of ``repro.launch.train``: a ``Trainer`` over a
simulated heterogeneous cluster (the paper's scheduler visibly rebalancing),
reduced unless ``--full`` is given, on the card unless ``--device`` names
another device.  ``main(argv)`` returns the trainer, its report and whether
it resumed, so a caller may run it in-process.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import RunConfig, get_arch, reduced
from ..configs.base import ShapeConfig
from ..distributed.simulated_cluster import SimulatedCluster, WorkerSpec
from ..train.trainer import Trainer


def simulated_fleet(workers: int) -> list:
    """The driver's heterogeneous simulated fleet: mu in U[5, 20], sigma in
    U[0.5, 2], drawn from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [WorkerSpec(mu=float(m), sigma=float(s))
            for m, s in zip(rng.uniform(5.0, 20.0, workers), rng.uniform(0.5, 2.0, workers))]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compression", default="none", choices=["none", "int8_ef", "topk_ef"])
    ap.add_argument("--device", default=None, help="torch device; the CUDA card when omitted")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("cli", seq_len=args.seq_len, global_batch=args.global_batch, kind="train")
    run = RunConfig(
        model=cfg, shape=shape, checkpoint_dir=args.ckpt_dir,
        total_steps=max(args.steps, 1), warmup_steps=max(args.steps // 10, 1),
        checkpoint_every=max(args.steps // 2, 1),
        grad_compression=args.compression,
    )
    trainer = Trainer(run, cluster=SimulatedCluster(simulated_fleet(args.workers)),
                      num_microbatches=args.microbatches, device=args.device)
    resumed = args.resume and trainer.try_restore()
    if resumed:
        print(f"resumed from step {trainer.step}")
    report = trainer.train(args.steps)
    print(f"steps={report.steps} loss: {report.losses[0]:.3f} -> {report.losses[-1]:.3f}")
    if report.splits:
        print("final microbatch split:", report.splits[-1])
    if report.makespans:
        k = max(len(report.makespans) // 4, 1)
        print("mean simulated makespan: first-quarter %.2f -> last-quarter %.2f"
              % (float(np.mean(report.makespans[:k])), float(np.mean(report.makespans[-k:]))))
    return dict(trainer=trainer, report=report, resumed=bool(resumed))


if __name__ == "__main__":
    main()
