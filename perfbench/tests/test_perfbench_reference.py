"""The plain references agree with the port at reduced sizes on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_CONFIGS
from perfbench import harness
from perfbench.drivers.serve import make_weights, model_config
from perfbench.reference import fleet as ref
from perfbench.reference import llama


def _fleet(k=24, n=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    mu = torch.linspace(0.5, 2.0, k)
    f = 0.05 + 0.9 * torch.rand((k, n), generator=g)
    t = f ** 0.9 * mu[:, None] + f ** 0.8 * 0.05 * mu[:, None] * torch.randn((k, n), generator=g)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((k,), generator=g)
    return g, mu, f, t, u


def test_normal_gamma_and_discount_match_the_port():
    from repro_torch.core import gibbs
    from repro_torch.core.moments import BetaParams
    from repro_torch.core.posterior import NormalGammaParams, update_normal_gamma

    g, mu, f, t, u = _fleet()
    prior = NormalGammaParams(u(0.5, 2), u(0.1, 3), u(1, 9), u(0.01, 1))
    mask = (torch.rand(t.shape, generator=g) > 0.2).float()
    alpha, beta = u(0.6, 0.95), u(0.5, 0.9)
    got = ref.normal_gamma(ref.NG(*prior), t, f, alpha, beta, mask)
    want = update_normal_gamma(prior, t, f, alpha, beta, mask)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
    ap, bp = BetaParams(u(1, 50), u(1, 50)), BetaParams(u(1, 50), u(1, 50))
    state = gibbs.GibbsState(prior, ap, bp, mu, u(1, 2), alpha, beta)
    disc = gibbs.discount_state(state, 0.9)
    ng, ap2, bp2 = ref.discount(ref.NG(*prior), ap, bp, 0.9)
    for a, b in zip([*ng, *ap2, *bp2], [*disc.ng, *disc.alpha_prior, *disc.beta_prior]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_exponent_posteriors_and_beta_fit_match_the_port():
    from repro_torch.core.moments import (BetaParams, exponent_grid, log_posterior_grid,
                                          update_alpha_beta_params)

    g, mu, f, t, u = _fleet()
    grid = exponent_grid(64)
    lam, alpha, beta = u(50, 400), u(0.6, 0.95), u(0.5, 0.9)
    ap, bp = BetaParams(u(1, 30), u(1, 30)), BetaParams(u(1, 30), u(1, 30))
    mask = torch.ones_like(t)
    got = ref.exponent_posteriors(grid, t, f, mu, lam, alpha, beta, ap, bp, mask, rows=7)
    want = log_posterior_grid(grid, t, f, mu, lam, alpha, beta, ap, bp, mask, symmetric_grid=True)
    scale = want.abs().amax(-1, keepdim=True)
    assert float(((got - want).abs() / scale).max()) < 1e-5
    fit_a, fit_b = update_alpha_beta_params(grid, t, f, mu, lam, alpha, beta, ap, bp, mask,
                                            symmetric_grid=True)
    mine = [*ref.beta_fit(grid, got[:, 0]), *ref.beta_fit(grid, got[:, 1])]
    for a, b in zip(mine, [*fit_a, *fit_b]):
        torch.testing.assert_close(a, b, rtol=5e-3, atol=1e-4)  # var = E[g^2] - E[g]^2 cancels
    lo = ref.beta_fit(grid, ref.exponent_posteriors(grid, t, f, mu, lam, alpha, beta, ap, bp,
                                                    mask, torch.bfloat16)[:, 0], torch.bfloat16)
    step = float(grid[1] - grid[0])
    assert ref.fit_gap(lo, fit_a, step) > 10 * ref.fit_gap(mine[:2], fit_a, step)


def test_frontier_solve_and_rounding_match_the_port():
    from repro_torch import sched
    from repro_torch.core.frontier import UnitParams, mean_var_completion

    g, mu, f, t, u = _fleet(k=16)
    p = UnitParams(mu, 0.05 * mu * u(0.5, 2), u(0.7, 0.95), u(0.6, 0.9))
    units = ref.Units(*p)
    fr = torch.softmax(torch.randn((3, 16), generator=g), -1)
    torch.testing.assert_close(ref.expected_makespan(fr, units, 128),
                               mean_var_completion(fr, p, 128)[0], rtol=1e-6, atol=0)
    want, _ = sched.solve_fractions(p, steps=30, num_points=128, min_fraction=1 / 128)
    got = ref.solve(units, steps=30, points=128, min_fraction=1 / 128)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    for k, total in ((16, 128), (1000, 8000)):
        g, mu, f, t, u = _fleet(k=k, seed=k)
        split = torch.softmax(0.5 * torch.randn((k,), generator=g), -1).numpy()
        np.testing.assert_array_equal(ref.round_counts(split, total),
                                      sched.quantize_fractions(split, total))


def test_a_split_is_named_by_the_candidate_it_is():
    g, mu, f, t, u = _fleet(k=16)
    units = ref.Units(mu, 0.05 * mu * u(0.5, 2), u(0.7, 0.95), u(0.6, 0.9))
    eq = ref._equalizing(units, torch.float32)
    assert ref.candidate(torch.full((16,), 1 / 16), units, 1 / 128) == "uniform"
    assert ref.candidate(eq, units, 1e-9) == "equalizing"
    moved = eq.clone()
    moved[0], moved[1] = moved[0] * 1.01, moved[1] - moved[0] * 0.01
    assert ref.candidate(moved, units, 1e-9) == "refined"


def test_llama_reference_matches_prefill_and_decode_through_the_cache():
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx

    cfg = dict(harness.load_json(ROOT / "perfbench/configs/yi-9b.json"), **TINY_CONFIGS["yi-9b"],
               torch_dtype="float32")
    mcfg = model_config(cfg)
    params = make_weights(mcfg, 3, "cpu")
    toks = torch.randint(0, cfg["vocab_size"], (3, 12), generator=torch.Generator().manual_seed(1))
    cache = model_zoo.init_cache(mcfg, 3, 20, torch.float32, device="cpu")
    logits, cache = model_zoo.prefill(mcfg, params, {"tokens": toks[:, :9]}, cache,
                                      ctx=ApplyCtx(mode="prefill"))
    steps = [logits]
    for i in range(9, 12):
        out, cache = model_zoo.decode_step(mcfg, params, toks[:, i:i + 1], cache,
                                           ctx=ApplyCtx(mode="decode"))
        steps.append(out)
    want = llama.logits_at(params, toks, cfg, torch.arange(8, 12))
    torch.testing.assert_close(torch.stack(steps, 1), want, rtol=1e-4, atol=1e-4)


def test_fp8_round_trip_is_coarser_than_bfloat16():
    w = torch.randn(256, 128) * 0.02
    e8 = (llama.fp8_round_trip(w) - w).abs().max() / w.abs().max()
    e16 = (w.to(torch.bfloat16).float() - w).abs().max() / w.abs().max()
    assert 4 * e16 < e8 < 0.07
