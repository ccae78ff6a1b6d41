"""End to end on the PyTorch port: train a ~100M-param LM for a few
hundred steps with the Bayesian partitioner balancing a simulated
heterogeneous 4-worker fleet.  The port's counterpart of
``examples/train_hetero.py``, with its settings.

    PYTHONPATH=src python examples/train_hetero_torch.py [--steps 300] [--small] [--device cpu]

--small uses a reduced config for a fast demo; the default trains the REAL
smollm-135m architecture (135M params) in float32 at short sequence length.
Without ``--device`` it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np

from repro_torch.configs import RunConfig, ShapeConfig, get_arch, reduced
from repro_torch.device import resolve_device
from repro_torch.distributed.simulated_cluster import SimulatedCluster, WorkerSpec
from repro_torch.train.trainer import Trainer, TrainerReport

# a fast, two medium, one slow worker: the partitioner must discover this
WORKERS = ((4.0, 0.4), (9.0, 0.8), (10.0, 0.9), (22.0, 2.0))
MICROBATCHES = 8


def main(argv=None) -> TrainerReport:
    """Train as the reference example does; returns the ``TrainerReport``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true", help="reduced config (fast demo)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_hetero_ckpt"))
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch("smollm-135m")
    # full 135M-param architecture in float32, or the reduced one; short
    # sequences either way
    cfg = reduced(cfg) if args.small else dataclasses.replace(cfg, dtype="float32")
    shape = ShapeConfig("demo", seq_len=64, global_batch=8, kind="train")

    run = RunConfig(
        model=cfg, shape=shape, checkpoint_dir=args.ckpt_dir,
        total_steps=args.steps, warmup_steps=max(args.steps // 20, 1),
        learning_rate=1e-3, checkpoint_every=max(args.steps // 3, 1),
        partitioner_refit_every=12,
    )
    cluster = SimulatedCluster([WorkerSpec(mu, sigma) for mu, sigma in WORKERS], seed=0)
    tr = Trainer(run, cluster=cluster, num_microbatches=MICROBATCHES, device=device)
    if tr.try_restore():
        print(f"resumed from checkpoint at step {tr.step}")

    print(f"training {cfg.name}: ~{tr.cfg.num_layers}L d={tr.cfg.d_model} "
          f"steps={args.steps} microbatches={MICROBATCHES}")
    rep = tr.train(args.steps, log_every=25)

    q = max(len(rep.losses) // 10, 1)
    print(f"\nloss: {np.mean(rep.losses[:q]):.3f} -> {np.mean(rep.losses[-q:]):.3f}")
    if rep.splits:
        print("microbatch split trajectory (1 row per refit):")
        for s in rep.splits:
            print("   ", s, " (true speeds ~ [4, 9, 10, 22] s/unit)")
    k = max(len(rep.makespans) // 4, 1)
    first, last = np.mean(rep.makespans[:k]), np.mean(rep.makespans[-k:])
    print(f"simulated step makespan: {first:.2f}s -> {last:.2f}s "
          f"({100 * (first - last) / first:.0f}% faster than the initial equal split)")
    return rep


if __name__ == "__main__":
    main()
