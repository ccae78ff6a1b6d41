"""Serving with QoS-aware batch partitioning on the PyTorch port, push-mode:
a request batch is split across heterogeneous replicas by the always-on
estimation service (``repro_torch.serve.ServiceLoop``).  The request loop
never calls the scheduler inline: it reads the last-good split from the
service's double-buffered host slot (non-blocking), serves, and pushes
measured telemetry into the device-resident ring; the service re-solves the
split only when the posterior actually moves (drift-gated cadence).

The QoS target stays a pluggable ``repro_torch.sched.Objective`` (min
latency, risk-averse mean+var, or a deadline quantile for tail-latency
control).  The port's counterpart of ``examples/serve_partitioned.py``,
with its constants.

    PYTHONPATH=src python examples/serve_partitioned_torch.py [--device cpu]

Without ``--device`` it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import sched, serve
from repro_torch.configs import get_arch, reduced
from repro_torch.device import resolve_device
from repro_torch.distributed.simulated_cluster import SimulatedCluster, WorkerSpec
from repro_torch.models import model_zoo
from repro_torch.models.layers import ApplyCtx
from repro_torch.train import serve_step

BATCH, ROUNDS, PUSHES = 24, 8, 8  # requests a round, rounds, telemetry rows a round
PROMPT, DECODE_STEPS, CACHE = 12, 2, 16


def serve_partitioned(cfg, device) -> dict:
    """The example's whole run on ``cfg`` at ``device``; returns what it
    printed: each round's counts, drift and propose flag, the service's
    counters, the learned split, the oracle makespans of the equal and the
    learned split, and the risk-averse and deadline splits with their stats;
    and the beliefs (``state``) both tail modes were solved on."""
    device = resolve_device(device)
    # --- a real model to serve ---------------------------------------------
    params = model_zoo.init_model_params(cfg, seed=0, device=device)
    # The model closures are built ONCE, outside the request loop.
    prefill = serve_step.make_prefill_step(cfg, ctx=ApplyCtx(mode="prefill"))
    decode = serve_step.make_decode_step(cfg, ctx=ApplyCtx(mode="decode"))

    # --- three serving replicas with different (unknown) speeds ------------
    cluster = SimulatedCluster(
        [WorkerSpec(2.0, 0.2, 0.95, 0.9), WorkerSpec(5.0, 0.8, 0.9, 0.85),
         WorkerSpec(3.0, 0.3, 0.92, 0.88)],
        seed=0,
    )

    # --- the always-on service: ring-buffered observe, drift-gated propose --
    config = serve.ServeConfig(
        sched=sched.SchedulerConfig(
            objective=sched.Objective.mean(), n_iters=12, grid_size=128,
            mu_guess=3.0,
        ),
        capacity=8,          # telemetry rows buffered between drains
        drift_threshold=0.05,
        max_staleness=6,
    )
    loop = serve.ServiceLoop(3, config=config, seed=1, device=device)

    # --- online phase: serve batches, push telemetry, tick the service ------
    rng = np.random.default_rng(0)
    rounds = []
    print("round | split (requests/replica) | batch latency | service")
    for rnd in range(ROUNDS):
        fr = loop.fractions()                       # non-blocking slot read
        counts = sched.quantize_fractions(
            fr, BATCH, sched.unit_params(loop.state.sched),
            objective=config.sched.objective,
        )
        fracs = counts / counts.sum()

        # actually run the model for one replica's shard (semantics demo)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (int(counts[0]), PROMPT)),
                               dtype=torch.int32, device=device)
        cache = model_zoo.init_cache(cfg, int(counts[0]), CACHE, torch.float32, device=device)
        token, cache = prefill(params, {"tokens": toks}, cache)
        for _ in range(DECODE_STEPS):
            token, cache = decode(params, token, cache)

        # telemetry: measured (simulated) per-replica latency, 8 rows per round
        for _ in range(PUSHES):
            loop.push(fracs, cluster.step_times(fracs))
        info = loop.tick()                          # drain -> observe -> propose?
        lat = float(np.max(cluster.step_times(fracs)))
        print(f"  {rnd}   | {counts} | {lat:.2f}s | drift={float(info.drift):.3f} "
              f"proposed={info.proposed}")
        rounds.append(dict(counts=counts, drift=float(info.drift), proposed=info.proposed,
                           tokens=token))

    c = loop.counters()
    fr = loop.fractions().copy()
    stats = loop.state.stats
    print(f"\nlearned split {np.round(fr, 3)}  "
          f"E[latency]={float(stats.e_t):.2f}s  Var={float(stats.var):.3f}")
    print(f"service counters: {c['drains']} drains, {c['proposes']} proposes "
          f"(skip rate {1.0 - c['proposes'] / max(c['drains'], 1):.2f})")
    eq = cluster.oracle_makespan(np.full(3, 1 / 3))
    lr = cluster.oracle_makespan(fr)
    print(f"true expected batch latency: equal={eq:.2f}s learned={lr:.2f}s "
          f"({100 * (eq - lr) / eq:.0f}% faster)")

    # tail-latency mode: same beliefs, different objective — spend a little
    # mean latency to buy predictability.  Pure API: score under a new Objective.
    state = loop.state.sched
    risk_cfg = sched.SchedulerConfig(objective=sched.Objective.mean_var(5.0))
    fr_r, st_r = sched.propose(state, risk_cfg)
    print(f"risk-averse split {np.round(fr_r.cpu().numpy(), 3)}  "
          f"E={float(st_r.e_t):.2f}s Var={float(st_r.var):.3f} "
          f"(vs Var={float(stats.var):.3f} at min-mean)")

    # deadline mode: maximize P(batch completes within eps)
    eps = 1.2 * float(stats.e_t)
    dl_cfg = sched.SchedulerConfig(objective=sched.Objective.deadline_quantile(eps))
    fr_d, st_d = sched.propose(state, dl_cfg)
    print(f"deadline({eps:.2f}s) split {np.round(fr_d.cpu().numpy(), 3)}  "
          f"P(t<=eps)={-float(st_d.score):.3f}")
    return dict(rounds=rounds, counters=c, config=config, state=state, fractions=fr,
                e_t=float(stats.e_t), var=float(stats.var), oracle_equal=eq, oracle_learned=lr,
                risk_fractions=fr_r.cpu().numpy(), risk_e_t=float(st_r.e_t),
                risk_var=float(st_r.var), eps=eps, deadline_fractions=fr_d.cpu().numpy(),
                deadline_p=-float(st_d.score))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card by default")
    args = parser.parse_args(argv)
    # --- a small real model to serve -----------------------------------------
    return serve_partitioned(reduced(get_arch("tinyllama-1.1b")), resolve_device(args.device))


if __name__ == "__main__":
    main()
