"""Fault-tolerance demo on the PyTorch port: mid-training worker failure ->
Bayesian detection -> eviction -> elastic re-partition -> checkpoint resume
-> hyperprior cold-start (a replacement worker admitted from the fleet prior
converges in measurably fewer observations than one from the global prior).
The port's counterpart of ``examples/elastic_failover.py``, with its
settings.

    PYTHONPATH=src python examples/elastic_failover_torch.py [--device cpu] [--ckpt-dir DIR]

Without ``--device`` it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch import sched
from repro_torch.configs import RunConfig, ShapeConfig, get_arch, reduced
from repro_torch.device import resolve_device
from repro_torch.distributed.simulated_cluster import SimulatedCluster, WorkerSpec
from repro_torch.train.trainer import Trainer

PHASE_STEPS = (16, 16, 16, 8)  # healthy, straggler, failure, after the resume
MICROBATCHES = 6
TRUE_MU, K = 600.0, 8  # phase 5: the fleet's true mu and its size
CFG5 = sched.SchedulerConfig(n_iters=3, grid_size=32, num_points=64, opt_steps=30, mu_guess=1.0)


def telemetry(rng, fracs=None, n=8):
    """Phase 5's telemetry: t = f^0.9 TRUE_MU (1 + 2 % noise), numpy rows
    that ``Scheduler.observe`` moves to its device."""
    if fracs is None:  # exploration rounds: varied f identifies (mu, alpha)
        fmat = rng.uniform(0.05, 0.9, (K, n)).astype(np.float32)
    else:
        fmat = np.tile(np.asarray(fracs, np.float32)[:, None], (1, n))
    tmat = fmat**0.9 * TRUE_MU * (1.0 + 0.02 * rng.standard_normal(fmat.shape))
    return sched.Telemetry(fmat, tmat.astype(np.float32))


def obs_to_fair_share(scheduler, rng, n=4, max_cycles=15):
    """Newcomer observations until its fraction is within 10% of oracle."""
    oracle = 1.0 / (K + 1)
    for cycle in range(max_cycles + 1):
        fr, _, _ = scheduler.propose_fractions()
        if abs(fr[-1] - oracle) <= 0.1 * oracle:
            return cycle * n
        scheduler.observe(telemetry(rng, fr, n=n))
    return (max_cycles + 1) * n


def own_stream(state: sched.SchedulerState) -> sched.SchedulerState:
    """``state`` with a generator of its own at the same point of the stream.
    The reference shares an immutable key; a ``torch.Generator`` is mutable,
    and sharing it would let one scheduler advance the stream another then
    starts from."""
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return state._replace(generator=gen)


def warm_fleet(device) -> sched.Scheduler:
    """Phase 5's fleet: K workers observed over six exploration rounds."""
    rng5 = np.random.default_rng(0)
    fleet = sched.Scheduler(K, config=CFG5, seed=0, device=device)
    for _ in range(6):
        fleet.observe(telemetry(rng5))
    return fleet


def cold_start(fleet: sched.Scheduler, device) -> dict:
    """Phase 5: a newcomer admitted from the pooled and from the global
    prior, each scheduler starting from the fleet's beliefs and stream.
    Returns the observations each took to reach fair share and the
    generator state each started from."""
    obs, starts = {}, {}
    for label, hierarchical in (("pooled", True), ("global", False)):
        s = sched.Scheduler(1, config=dataclasses.replace(CFG5, hierarchical=hierarchical),
                            device=device)
        s.state = own_stream(fleet.state)  # share the beliefs, then diverge
        starts[label] = s.state.generator.get_state()
        s.add_workers(1, seed=7)
        obs[label] = obs_to_fair_share(s, np.random.default_rng(1))
        print(f"  {label} prior admit: {obs[label]} observations to fair share")
    return dict(obs=obs, starts=starts)


def main(argv=None) -> dict:
    """The five phases; returns what they print: losses, splits, the last
    straggler event, the fleet size and events, the resumed step and mu,
    and phase 5's observation counts."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_failover_ckpt"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(get_arch("tinyllama-1.1b"))
    shape = ShapeConfig("demo", seq_len=32, global_batch=12, kind="train")
    run = RunConfig(
        model=cfg, shape=shape, checkpoint_dir=args.ckpt_dir,
        total_steps=60, warmup_steps=3, checkpoint_every=10,
        partitioner_refit_every=8, straggler_threshold_sigma=2.5,
    )
    cluster = SimulatedCluster(
        [WorkerSpec(5.0, 0.4), WorkerSpec(5.5, 0.4), WorkerSpec(6.0, 0.5)], seed=0
    )
    tr = Trainer(run, cluster=cluster, num_microbatches=MICROBATCHES, device=device)
    out = {}

    print("phase 1: healthy fleet (3 workers)")
    rep1 = tr.train(PHASE_STEPS[0])
    out["split1"] = np.bincount(tr._worker_of_mb, minlength=3)
    out["losses1"] = rep1.losses
    print(f"  loss {rep1.losses[0]:.3f} -> {rep1.losses[-1]:.3f}; split {out['split1']}")

    print("phase 2: worker 1 degrades (straggler) ...")
    cluster.degrade(1, mu_factor=5.0)
    tr.train(PHASE_STEPS[1])
    strag = [e for e in tr.monitor.events if e["type"] == "straggler"]
    out["straggler"] = strag[-1] if strag else None
    out["split2"] = np.bincount(tr._worker_of_mb, minlength=3)
    print(f"  straggler events: {strag[-1] if strag else 'none'}")
    print(f"  rebalanced split {out['split2']} (work shifted off worker 1)")

    print("phase 3: worker 2 dies (heartbeat lost) ...")
    cluster.fail(2)
    rep3 = tr.train(PHASE_STEPS[2])
    out["fleet_size"] = tr.partitioner.num_workers
    out["events"] = [e["type"] for e in tr.monitor.events]
    out["losses3"] = rep3.losses
    print(f"  fleet size now {out['fleet_size']} (events: {out['events']})")
    print(f"  training continued: loss {rep3.losses[0]:.3f} -> {rep3.losses[-1]:.3f}")

    print("phase 4: restart from checkpoint (crash-resume)")
    tr.save()
    tr.ckpt.wait()
    tr2 = Trainer(run, cluster=cluster, num_microbatches=MICROBATCHES, device=device)
    assert tr2.try_restore()
    # the scheduler's Bayesian beliefs are part of the checkpoint tree: the
    # restarted trainer proposes from the LEARNED posteriors, not fresh priors
    mu_saved = tr.partitioner.state.gibbs.mu.cpu().numpy()
    mu_restored = tr2.partitioner.state.gibbs.mu.cpu().numpy()
    np.testing.assert_array_equal(mu_saved, mu_restored)
    out["resumed_step"], out["mu_restored"] = tr2.step, mu_restored
    print(f"  resumed at step {tr2.step}; beliefs restored bit-exactly "
          f"(mu={np.round(mu_restored, 2)}); continuing {PHASE_STEPS[3]} more steps")
    rep4 = tr2.train(PHASE_STEPS[3])
    out["losses4"] = rep4.losses
    print(f"  post-resume loss: {rep4.losses[-1]:.3f} (finite={np.isfinite(rep4.losses[-1])})")

    print("phase 5: hyperprior cold-start (replacing the dead worker)")
    # Elastic recovery eventually admits a REPLACEMENT.  With hierarchical
    # pooling the newcomer is born from the fleet's empirical-Bayes hyperprior
    # (repro_torch.hier) instead of the vague global prior, so it converges to
    # its fair share of work in measurably fewer observations, shown here on
    # the scheduler directly.
    obs = cold_start(warm_fleet(device), device)["obs"]
    out["obs"] = obs
    # self-check: the acceptance gap, not just a demo print
    assert obs["pooled"] <= obs["global"] / 2, obs
    print(f"  cold-start transfer: {obs['pooled']} vs {obs['global']} obs "
          f"({obs['global'] - obs['pooled']} saved by pooling)")
    return out


if __name__ == "__main__":
    main()
