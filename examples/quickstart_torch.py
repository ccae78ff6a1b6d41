"""Quickstart on the PyTorch port: learn two processing units' characteristics
from passive telemetry and pick the frontier-optimal split (the whole paper
in ~60 lines).  Runs on the CUDA card by default; pass ``--device cpu`` to run
the kernels' plain versions on the CPU instead.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import fit, optimal_two_way_fraction, pareto_mask, sweep_two_way
from repro_torch.core.frontier import UnitParams

# Two heterogeneous processing units (ground truth UNKNOWN to the system).
# Unit i is slow but steady; unit j is fast but noisy (paper's Fig 1 setup).
TRUE = dict(i=dict(mu=30.0, sigma=2.0, alpha=0.92, beta=0.85),
            j=dict(mu=20.0, sigma=6.0, alpha=0.88, beta=0.80))
N = 384


def telemetry(seed: int = 0):
    """Telemetry from ACTUAL workloads — no controlled experiments (paper §1)."""
    rng = np.random.default_rng(seed)

    def observe(unit, f):
        p = TRUE[unit]
        noise = rng.normal(size=f.shape)
        return np.maximum(f ** p["alpha"] * p["mu"] + f ** p["beta"] * p["sigma"] * noise, 1e-3)

    f_seen = rng.uniform(0.05, 0.95, N).astype(np.float32)
    t_i = observe("i", f_seen).astype(np.float32)
    t_j = observe("j", 1.0 - f_seen).astype(np.float32)
    return f_seen, t_i, t_j


def learn(device=None):
    """Gibbs-estimate each unit (Algorithm 1, chained priors)."""
    f_seen, t_i, t_j = telemetry()
    kw = dict(batch_size=64, n_iters=15, grid_size=256, device=device)
    st_i, _ = fit(1, t_i, f_seen, **kw)
    st_j, _ = fit(2, t_j, 1.0 - f_seen, **kw)
    return st_i, st_j


def frontier_choices(st_i, st_j):
    """f* for min expected time / risk-averse / var-budget QoS."""
    stack = lambda name: torch.stack([getattr(st_i, name), getattr(st_j, name)])
    params = UnitParams(stack("mu"), stack("sigma"), stack("alpha"), stack("beta"))
    choices = []
    for obj, kw in [("mean", {}), ("mean_var", dict(risk_aversion=1.0)),
                    ("constrained", dict(var_budget=6.0))]:
        f_opt, m, v = optimal_two_way_fraction(params, objective=obj, **kw)
        choices.append((obj, float(f_opt), float(m), float(v)))
    return params, choices


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args()

    st_i, st_j = learn(args.device)
    for name, st in (("i", st_i), ("j", st_j)):
        learned = dict(mu=st.mu, sigma=st.sigma, alpha=st.alpha, beta=st.beta)
        print(f"learned unit {name}:", {k: round(float(v), 3) for k, v in learned.items()})
        print(f"true    unit {name}:", TRUE[name])

    params, choices = frontier_choices(st_i, st_j)
    fg, mu_f, var_f = sweep_two_way(params, num_f=101)
    mask = pareto_mask(mu_f, var_f).cpu().numpy()
    print("\n  f      mu(f)  var(f)  frontier")
    for k in range(0, 101, 10):
        star = "*" if mask[k] else ""
        print(f"  {float(fg[k]):.2f}   {float(mu_f[k]):6.2f} {float(var_f[k]):7.2f}  {star}")
    for obj, f_opt, m, v in choices:
        print(f"objective={obj:11s} -> f*={f_opt:.3f} E[t]={m:.2f} Var[t]={v:.2f}")


if __name__ == "__main__":
    main()
