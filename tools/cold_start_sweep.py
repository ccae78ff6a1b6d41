"""Phase 5 of ``examples/elastic_failover.py`` (the reference) and of
``examples/elastic_failover_torch.py`` (the port) over many seeds, on the
CPU: how many observations a newcomer from the pooled and from the global
prior takes to reach its fair share.

    PYTHONPATH=src:examples JAX_PLATFORMS=cpu python tools/cold_start_sweep.py [--seeds 60]

Seed s draws the fleet's scheduler and exploration telemetry from s, the
newcomer from 7 + s and its telemetry from 1 + s (s = 0 is the examples'
own).  Three rows a seed: the reference; the port; the port from the
reference's warmed fleet, carried over by ``convert.to_scheduler_state``.
Prints each row, then each column's global counts, their mean and median,
a Mann-Whitney U test of the port's against the reference's, and at how
many seeds the examples' assert pooled <= global / 2 holds.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.stats import mannwhitneyu

import elastic_failover_torch as port_example
from repro import sched as ref_sched
from repro_torch import convert

K = port_example.K
# examples/elastic_failover.py's phase-5 settings, the port example's CFG5
REF_CFG = ref_sched.SchedulerConfig(n_iters=3, grid_size=32, num_points=64, opt_steps=30,
                                    mu_guess=1.0)


def ref_telemetry(rng, fracs=None, n=8):
    """The port example's draws, as the reference's ``Telemetry``."""
    t = port_example.telemetry(rng, fracs, n)
    return ref_sched.Telemetry(jnp.asarray(t.fracs), jnp.asarray(t.times))


def ref_obs_to_fair_share(s, rng, n=4, max_cycles=15):
    oracle = 1.0 / (K + 1)
    for cycle in range(max_cycles + 1):
        fr, _, _ = s.propose_fractions()
        if abs(float(fr[-1]) - oracle) <= 0.1 * oracle:
            return cycle * n
        s.observe(ref_telemetry(rng, np.asarray(fr), n=n))
    return (max_cycles + 1) * n


def reference(seed, add_seed, obs_seed):
    rng = np.random.default_rng(seed)
    fleet = ref_sched.Scheduler(K, config=REF_CFG, seed=seed)
    for _ in range(6):
        fleet.observe(ref_telemetry(rng))
    out = {}
    for label, hierarchical in (("pooled", True), ("global", False)):
        s = ref_sched.Scheduler(1, config=dataclasses.replace(REF_CFG, hierarchical=hierarchical))
        s.state = fleet.state
        s.add_workers(1, seed=add_seed)
        out[label] = ref_obs_to_fair_share(s, np.random.default_rng(obs_seed))
    return out, jax.tree_util.tree_map(np.asarray, fleet.state)


def port(seed, add_seed, obs_seed, fleet_state=None):
    fleet = port_example.sched.Scheduler(K, config=port_example.CFG5, seed=seed, device="cpu")
    if fleet_state is None:
        rng = np.random.default_rng(seed)
        for _ in range(6):
            fleet.observe(port_example.telemetry(rng))
    else:
        fleet.state = fleet_state
    out = {}
    for label, hierarchical in (("pooled", True), ("global", False)):
        s = port_example.sched.Scheduler(
            1, config=dataclasses.replace(port_example.CFG5, hierarchical=hierarchical), device="cpu")
        s.state = port_example.own_stream(fleet.state)
        s.add_workers(1, seed=add_seed)
        out[label] = port_example.obs_to_fair_share(s, np.random.default_rng(obs_seed))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=60)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    rows = []
    for s in range(args.seeds):
        want, ref_state = reference(s, 7 + s, 1 + s)
        carried = convert.to_scheduler_state(ref_state, seed=s, device="cpu")
        rows.append(dict(seed=s, ref=want, port=port(s, 7 + s, 1 + s),
                         port_from_ref=port(s, 7 + s, 1 + s, carried)))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for col in ("ref", "port", "port_from_ref"):
        g = [r[col]["global"] for r in rows]
        holds = sum(r[col]["pooled"] <= r[col]["global"] / 2 for r in rows)
        summary[col] = dict(mean=float(np.mean(g)), median=float(np.median(g)), holds=holds)
        if col != "ref":
            summary[col]["mwu_p"] = float(mannwhitneyu(g, [r["ref"]["global"] for r in rows]).pvalue)
        print(f"{col}: global {g}; mean {np.mean(g):.2f}, median {np.median(g):g}; "
              f"pooled <= global / 2 at {holds} of {len(rows)} seeds"
              + (f"; Mann-Whitney U against ref p = {summary[col]['mwu_p']:.3f}" if col != "ref" else ""))
    return summary


if __name__ == "__main__":
    main()
