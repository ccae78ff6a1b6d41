"""Multi-stage pipeline demo on the PyTorch port: stage-wise Bayesian splits
vs uniform splits, then a stochastic diamond refereed by the simulator.

The port's counterpart of ``examples/pipeline_dag.py``, with its
configuration and its three assertions:

  1. a 3-stage chain (ingest -> transform -> publish) of 4 heterogeneous
     workers each is learned online, the whole (S, K, N) telemetry block
     advancing as one stacked fleet (one K1 launch per Gibbs sweep on a
     card), and the stage-wise split beats the uniform split end to end at
     the true parameters;
  2. on a 4-stage diamond with a p = 0.3 conditional stage and a rework
     loop (40 % per attempt, up to 4 attempts) under an end-to-end variance
     budget, the split that knows the topology beats the one that assumes it
     away, and the uniform split, on the Monte-Carlo simulator with common
     random numbers.

    PYTHONPATH=src python examples/pipeline_dag_torch.py [--device cpu]

Without ``--device`` it runs on the card, and raises where there is none.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import sched, sim
from repro_torch.core.frontier import UnitParams

S, K, N = 3, 4, 96
STAGES = ("ingest", "transform", "publish")

# Ground truth (unknown to the scheduler): every stage has a 4-6x speed
# spread across its workers, and the spreads do not line up across stages.
TRUE_MU = np.array(
    [
        [4.0, 9.0, 16.0, 24.0],   # ingest
        [20.0, 5.0, 12.0, 30.0],  # transform (different worker is fastest)
        [8.0, 8.0, 3.0, 18.0],    # publish
    ],
    np.float32,
)
TRUE_SIGMA = np.full((S, K), 1.0, np.float32)
ALPHA = BETA = 0.9


def learned_chain(device, rng: np.random.Generator) -> dict:
    """Part 1: learn the chain online, propose, compare with uniform at the
    true parameters, and check the composed moments by Monte Carlo."""

    def telemetry(fracs: np.ndarray) -> sched.Telemetry:
        # Request sizes vary around each share (paper section 1): that is
        # what identifies the scaling exponents.
        jitter = rng.uniform(0.3, 1.7, size=(S, K, N))
        f = np.clip(fracs[..., None] * jitter, 0.02, 0.98).astype(np.float32)
        noise = rng.normal(size=(S, K, N))
        t = np.maximum(
            f**ALPHA * TRUE_MU[..., None] + f**BETA * TRUE_SIGMA[..., None] * noise, 1e-3
        ).astype(np.float32)
        as_t = lambda x: torch.as_tensor(x, device=device)
        return sched.Telemetry(fracs=as_t(f), times=as_t(t))

    dag = sched.WorkflowDAG.chain(S, K)
    config = sched.SchedulerConfig(n_iters=10, grid_size=128, mu_guess=12.0)
    state = sched.init_dag(config, dag, seed=0, device=device)
    fracs = sched.uniform_fractions(dag, device).cpu().numpy()  # start naive
    for round_ in range(5):
        state, ll = sched.observe_dag(state, telemetry(fracs), config)
        proposal, stats = sched.propose_dag(state, dag, config)
        fracs = proposal.cpu().numpy()
        print(f"round {round_}: mean ll={float(ll.mean()):8.2f}   "
              f"E[end-to-end]={float(stats.e_t):6.2f}  Var={float(stats.var):.3f}")

    learned = sched.stage_params(state)
    print("\nlearned stage speeds (posterior mean mu, true in parens):")
    for si, name in enumerate(STAGES):
        row = "  ".join(f"{float(learned.mu[si, k]):5.1f} ({TRUE_MU[si, k]:4.1f})" for k in range(K))
        print(f"  {name:10s} {row}")

    true_params = UnitParams.of(
        TRUE_MU, TRUE_SIGMA, np.full((S, K), ALPHA, np.float32), np.full((S, K), BETA, np.float32)
    )
    true_params = UnitParams(*(x.to(device) for x in true_params))
    st_bayes = sched.dag_stats(dag, torch.as_tensor(fracs, device=device), true_params)
    st_uni = sched.dag_stats(dag, sched.uniform_fractions(dag, device), true_params)
    print("\nend-to-end completion (at TRUE parameters):")
    print(f"  uniform splits   E[t]={float(st_uni.e_t):6.2f}  Var={float(st_uni.var):6.3f}")
    print(f"  Bayesian splits  E[t]={float(st_bayes.e_t):6.2f}  Var={float(st_bayes.var):6.3f}")
    gain = 100.0 * (1.0 - float(st_bayes.e_t) / float(st_uni.e_t))
    print(f"  -> {gain:.1f}% lower expected end-to-end latency")
    print("\nper-stage splits (workers sorted fast->slow get more->less):")
    for si, name in enumerate(STAGES):
        print(f"  {name:10s} " + "  ".join(f"{fracs[si, k]:.3f}" for k in range(K)))

    n_mc = 200_000
    total = np.zeros(n_mc)
    for si in range(S):
        mean = fracs[si] ** ALPHA * TRUE_MU[si]
        std = fracs[si] ** BETA * TRUE_SIGMA[si]
        total += rng.normal(mean, std, size=(n_mc, K)).max(axis=1)
    print(f"\ncomposed E[t]={float(st_bayes.e_t):.2f} vs Monte-Carlo {total.mean():.2f}  "
          f"(Var {float(st_bayes.var):.3f} vs {total.var():.3f})")
    return dict(e_bayes=float(st_bayes.e_t), e_uniform=float(st_uni.e_t))


def diamond_fixture(device):
    """The stochastic diamond: (dag, dag_sto, true params, config)."""
    s4, k4 = 4, 8
    diamond = sched.WorkflowDAG.from_edges(s4, ((0, 1), (0, 2), (1, 3), (2, 3)), num_workers=k4)
    diamond_sto = diamond.with_stochastic(
        exec_probs=(1.0, 0.3, 1.0, 1.0),    # stage 1 is conditional
        rework_probs=(0.0, 0.0, 0.4, 0.0),  # stage 2 loops on failure
        max_retries=(1, 1, 4, 1),
    )
    # Fast-but-noisy workers 0-3 vs slow-but-precise workers 4-7.
    base_mu = np.asarray([5.0] * 4 + [9.0] * 4, np.float32)
    base_sig = np.asarray([6.0] * 4 + [0.3] * 4, np.float32)
    stage_scale = np.asarray([0.4, 1.6, 0.5, 0.4], np.float32)
    true4 = UnitParams.of(
        stage_scale[:, None] * base_mu[None, :],
        stage_scale[:, None] * base_sig[None, :],
        np.full((s4, k4), 0.9, np.float32),
        np.full((s4, k4), 0.55, np.float32),
    )
    true4 = UnitParams(*(x.to(device) for x in true4))
    cfg4 = sched.SchedulerConfig(
        objective=sched.Objective.variance_budget(2.0), opt_steps=200, num_points=256
    )
    return diamond, diamond_sto, true4, cfg4


def stochastic_diamond(device, num_samples: int = 200_000) -> dict:
    """Part 2: topology-aware vs topology-blind vs uniform splits, priced on
    one sampled world (common random numbers: seed 42 for all three)."""
    diamond, diamond_sto, true4, cfg4 = diamond_fixture(device)
    st4 = sched.init_dag(cfg4, diamond, seed=0, device=device)
    f_det, _ = sched.propose_dag(st4, diamond, cfg4, params=true4)      # topology-blind
    f_sto, _ = sched.propose_dag(st4, diamond_sto, cfg4, params=true4)  # topology-aware
    f_uni = sched.uniform_fractions(diamond, device)
    price = lambda f: sim.simulate_workflow(
        42, diamond_sto, f, true4, num_samples=num_samples, device=device)
    t_det, t_sto, t_uni = price(f_det), price(f_sto), price(f_uni)
    out = dict(
        e_uniform=float(t_uni.mean()), e_det=float(t_det.mean()), e_sto=float(t_sto.mean()),
        gap_det=float((t_det - t_sto).mean()), gap_uniform=float((t_uni - t_sto).mean()),
        se_det=float((t_det - t_sto).std() / len(t_sto) ** 0.5),
    )
    print("\nstochastic diamond (p=0.3 branch, 40% rework), simulator-measured E[t]:")
    print(f"  uniform splits            {out['e_uniform']:7.3f}")
    print(f"  deterministic-assumption  {out['e_det']:7.3f}")
    print(f"  stochastic-aware          {out['e_sto']:7.3f}")
    print(f"  -> knowing the topology saves {out['gap_det']:+.4f} E[t] vs assuming it away "
          f"(paired standard error {out['se_det']:.4f})")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or the card by default")
    args = parser.parse_args(argv)
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    chain = learned_chain(device, np.random.default_rng(0))
    assert chain["e_bayes"] < chain["e_uniform"], "Bayesian splits must beat uniform"
    print("\nOK: stage-wise Bayesian splits beat uniform splits end-to-end.")

    diamond = stochastic_diamond(device)
    assert diamond["gap_det"] > 0.0, "stochastic-aware proposal must beat the deterministic assumption"
    assert diamond["gap_uniform"] > 0.0
    print("\nOK: stochastic-aware splits beat both baselines on the simulator.")


if __name__ == "__main__":
    main()
