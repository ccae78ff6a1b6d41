"""Driver of the estimation service at fleet scale (``repro_torch.serve``).

A closed loop of cycles over one ``ServiceLoop``: push one ring of telemetry
rows for all K workers, ``tick``, wait for the publish if the tick
proposed (an async solve), then quantize the published split to 8 K
microbatches by largest-remainder rounding (``sched.quantize_fractions``
without the beliefs: the move refinement takes ~110 s a call at K = 1e5).  The
telemetry is drawn on the card from the seed: mu = linspace(lo, hi, K),
each row's split the shares proportional to 1 / mu times U(0.5, 1.5),
renormalised, t = f^alpha mu + f^beta noise mu N(0, 1).

Spans (host clock): ``cycle`` (telemetry in to counts out), ``advance`` (the
tick up to its flag read), ``dispatch`` (enqueuing the async solve),
``publish`` (dispatch to the publish), ``quantize``.  Work: ``obs`` (K x ring
rows a finished cycle), ``attempted`` and ``completed`` cycles; counters:
``drains`` and ``proposes`` over the window.

The check follows the program from its own state, as the reference can
only replay the deterministic steps of a Gibbs sweep, not its draws.  At a
few cycles drawn from the seed the inputs of the tick's last sweep are kept
as the program passes them (``update_normal_gamma`` and
``update_alpha_beta_params`` of ``repro_torch.core.gibbs``, wrapped by
name), beside the telemetry pushed and the beliefs before the tick.  After
the window the reference recomputes:

  * ``start_gap``: the sweep's prior (the discounted beliefs before the
    tick) and its batch (the rows pushed);
  * ``ng_gap``: the Normal-Gamma posterior the tick chained into its state;
  * ``beta_fit_gap``: the Beta fits of alpha and beta it chained (K1's grid,
    the moments, the fit), as the widest gap of their means or standard
    deviations in grid steps;
  * ``frontier_gap``: a published split's E[makespan] and variance, as the
    solve published them, against the reference's quadrature of that split
    under the beliefs it was solved from (relative to E and E^2);
  * ``solve_gap``: how far the published split's E[makespan] lies above
    that of the reference's own solve from the same beliefs (relative; below
    0 where the program's split is the better);
  * ``counts_off``: the share of the 8 K microbatches that the counts
    quantized from a split place elsewhere than the reference's rounding
    of it (an exact comparison).
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.harness import log
from perfbench.reference import fleet as ref

SPIED = ("update_normal_gamma", "update_alpha_beta_params")


def seeds(seed: int, n: int):
    return [int(x) for x in np.random.SeedSequence(seed).generate_state(n, dtype=np.uint64) >> 1]


class Spy:
    """Keeps the arguments of the last call of each wrapped function while armed."""

    def __init__(self, module, names):
        self.armed, self.calls = False, {}
        self._orig = {n: getattr(module, n) for n in names}
        self._module = module
        for n, fn in self._orig.items():
            setattr(module, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def spied(*args, **kwargs):
            if self.armed:
                self.calls[name] = args
            return fn(*args, **kwargs)
        return spied

    def arm(self):
        self.armed, self.calls = True, {}

    def disarm(self) -> dict:
        self.armed = False
        return self.calls

    def remove(self):
        for n, fn in self._orig.items():
            setattr(self._module, n, fn)


def service_config(cfg, mix):
    from repro_torch import sched, serve

    k = cfg["workers"]
    return serve.ServeConfig(
        sched=sched.SchedulerConfig(
            n_iters=cfg["sweeps"], grid_size=cfg["grid_size"], num_points=cfg["num_points"],
            opt_steps=cfg["opt_steps"], mu_guess=cfg["mu_guess"],
            min_fraction=1.0 / (cfg["microbatches_per_worker"] * k)),
        capacity=cfg["ring"], drift_threshold=mix["drift_threshold"],
        max_staleness=mix["max_staleness"], gate_z=mix["gate_z"], gate_warmup=mix["gate_warmup"],
        active_size=cfg["active_size"], async_propose=mix["async_propose"])


def truth(cfg, device, seed):
    """The fleet's shares and a draw of one telemetry row, on the device: the
    row's split is the truth's shares times U(1 - spread, 1 + spread),
    renormalised, so that each worker is seen at several fractions (at one
    fraction its exponent alpha and its mu cannot be told apart)."""
    import torch

    k, tr = cfg["workers"], cfg["truth"]
    mu = torch.linspace(tr["mu_lo"], tr["mu_hi"], k, device=device)
    fracs = (1.0 / mu) / torch.sum(1.0 / mu)
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw():
        u = torch.rand((k,), generator=gen, device=device)
        f = fracs * (1.0 + tr["split_spread"] * (2.0 * u - 1.0))
        f = f / torch.sum(f)
        z = torch.randn((k,), generator=gen, device=device)
        return f, f ** tr["alpha"] * mu + f ** tr["beta"] * tr["noise"] * mu * z
    return fracs, draw


def run(rec, cfg, mix, seed, device):
    import torch
    from repro_torch import sched, serve
    from repro_torch.core import gibbs

    s_loop, s_truth, s_pick = seeds(seed, 3)
    config = service_config(cfg, mix)
    k, ring = cfg["workers"], cfg["ring"]
    total = cfg["microbatches_per_worker"] * k
    spy = Spy(gibbs, SPIED)
    loop = serve.ServiceLoop(k, config=config, seed=s_loop, device=device)
    _, draw = truth(cfg, device, s_truth)
    pick = np.random.default_rng(s_pick)
    chk = mix["check"]
    armed_at = set()
    samples = dict(gibbs=[], splits=[], quantized=[], total=total, config=config)

    def cycle(i=None):
        t0 = time.perf_counter()
        rows = [draw() for _ in range(ring)]
        for f, t in rows:
            loop.push(f, t)
        armed = i in armed_at
        if armed:
            before = loop.state.sched.gibbs
            spy.arm()
        a0 = time.perf_counter()
        info = loop.tick()
        a1 = time.perf_counter()
        if armed:
            samples["gibbs"].append(dict(before=before, after=loop.state.sched.gibbs,
                                         calls=spy.disarm(), rows=rows))
        if info.proposed and config.async_propose:
            d0, d1 = loop.last_dispatch
            rec.add_span("advance", a0, d0)
            rec.add_span("dispatch", d0, d1)
            while not loop.poll():
                time.sleep(1e-4)
            rec.add_span("publish", d0, time.perf_counter())
            samples["splits"].append((loop.state.ref, loop.fractions().copy(), loop.state.stats,
                                      rec.measuring))
        else:
            rec.add_span("advance", a0, a1)
        q0 = time.perf_counter()
        fr = loop.fractions()
        counts = sched.quantize_fractions(fr, total)
        q1 = time.perf_counter()
        rec.add_span("quantize", q0, q1)
        rec.add_span("cycle", t0, q1)
        if rec.measuring:
            samples["quantized"].append((len(samples["splits"]) - 1, counts))
        rec.add_work("obs", k * ring)
        rec.add_work("completed", 1)

    try:
        w0 = time.perf_counter()
        for _ in range(mix["warm_cycles"]):
            cycle()
        if device.type == "cuda":
            torch.cuda.synchronize()
        log(f"{mix['warm_cycles']} warm cycles in {time.perf_counter() - w0:.2f} s")
        # Sampled ticks among the first cycles the window is sure to reach.
        reach = max(1, int(0.8 * rec.seconds * mix["warm_cycles"] / (time.perf_counter() - w0)))
        span = min(chk["gibbs_from"], reach)
        armed_at = set(pick.choice(span, size=min(chk["gibbs_cycles"], span),
                                   replace=False).tolist())
        start = loop.counters()
        with rec.window():
            i = 0
            while not rec.expired():
                rec.add_work("attempted", 1)
                cycle(i)
                i += 1
            rec.add_launch("posterior_grid_fleet", (k, ring, cfg["grid_size"]),
                           cfg["sweeps"] * int(rec.work.get("completed", 0)))
        end = loop.counters()
        rec.counters = {n: end[n] - start[n] for n in ("drains", "proposes", "dropped")}
    finally:
        spy.remove()
    return samples


def check(samples, cfg, mix, seed, control=False):
    """The numbers of the check.  With ``control`` the reference computed in
    bfloat16, the precision below the configuration's float32, stands in
    the program's place."""
    import torch

    dtype = torch.bfloat16 if control else torch.float32
    precision = dtype if control else None
    pick = np.random.default_rng(seeds(seed, 4)[3])
    config = samples["config"]
    rho = config.sched.discount
    out = dict(start_gap=0.0, ng_gap=0.0, beta_fit_gap=0.0, frontier_gap=0.0,
               solve_gap=-np.inf, counts_off=0.0)
    if not samples["gibbs"]:
        raise RuntimeError("no sampled tick ran in the window")
    for s in samples["gibbs"]:
        calls = s["calls"]
        if set(calls) != set(SPIED):
            raise RuntimeError(f"the tick's sweeps called {sorted(calls)} of {SPIED}")
        prior, t, f, alpha, beta, mask = calls["update_normal_gamma"][:6]
        (grid, t2, f2, mu, lam, alpha2, beta2, ap, bp, mask2) = calls["update_alpha_beta_params"][:10]
        pre = s["before"]
        want_ng, want_ap, want_bp = ref.discount(ref.NG(*pre.ng), pre.alpha_prior, pre.beta_prior, rho)
        want_f = torch.stack([f for f, _ in s["rows"]], dim=1)
        want_t = torch.stack([t for _, t in s["rows"]], dim=1)
        got_start = [*prior, *ap, *bp, t, f, t2, f2, mask, mask2]
        want_start = [*want_ng, *want_ap, *want_bp, want_t, want_f, want_t, want_f,
                      torch.ones_like(want_t), torch.ones_like(want_t)]
        if precision is not None:  # the control: the reference in the lower precision
            lo_ng, lo_ap, lo_bp = ref.discount(ref.NG(*pre.ng), pre.alpha_prior, pre.beta_prior,
                                               rho, dtype)
            got_start = [*lo_ng, *lo_ap, *lo_bp] + [x.to(dtype).float() for x in got_start[8:]]
        out["start_gap"] = max(out["start_gap"], max(
            ref.relative_gap(g, w) for g, w in zip(got_start, want_start)))
        # The Normal-Gamma update and the Beta fits, at the sweep's own inputs.
        post = s["after"]
        want = ref.normal_gamma(ref.NG(*prior), t, f, alpha, beta, mask)
        got = ref.normal_gamma(ref.NG(*prior), t, f, alpha, beta, mask, dtype) \
            if precision is not None else ref.NG(*post.ng)
        out["ng_gap"] = max(out["ng_gap"], max(ref.relative_gap(g, w) for g, w in zip(got, want)))
        logp = ref.exponent_posteriors(grid, t2, f2, mu, lam, alpha2, beta2, ap, bp, mask2)
        want_fit = [*ref.beta_fit(grid, logp[:, 0]), *ref.beta_fit(grid, logp[:, 1])]
        if precision is not None:
            lo = ref.exponent_posteriors(grid, t2, f2, mu, lam, alpha2, beta2, ap, bp, mask2, dtype)
            got_fit = [*ref.beta_fit(grid, lo[:, 0], dtype), *ref.beta_fit(grid, lo[:, 1], dtype)]
        else:
            got_fit = [*post.alpha_prior, *post.beta_prior]
        step = float(grid[1] - grid[0])
        out["beta_fit_gap"] = max(out["beta_fit_gap"],
                                  ref.fit_gap(got_fit[:2], want_fit[:2], step),
                                  ref.fit_gap(got_fit[2:], want_fit[2:], step))
        del logp
    # The splits published in the window (where none was, the one in force):
    # their published E and Var against the reference's quadrature of the
    # split under the beliefs it was solved from, and their E against that
    # of the reference's own solve from those beliefs; the counts quantized
    # from them against the reference's rounding.
    splits, total = samples["splits"], samples["total"]
    if not splits:
        raise RuntimeError("no split was published")
    in_window = [j for j, sp in enumerate(splits) if sp[3]] or [len(splits) - 1]
    sc = config.sched
    points = sc.num_points
    solve = dict(steps=sc.opt_steps, lr=sc.opt_lr, points=points, min_fraction=sc.min_fraction)
    for j in sorted(pick.choice(in_window, size=min(mix["check"]["splits"], len(in_window)),
                                replace=False)):
        params, published, stats, _ = splits[j]
        units = ref.Units(*params)
        split = torch.as_tensor(published, device=units.mu.device)
        e_ref, v_ref = ref.makespan_moments(split, units, points)
        e_got, v_got = stats.e_t, stats.var
        if control:
            e_got, v_got = ref.makespan_moments(split, units, points, dtype)
        bad = not bool(torch.isfinite(split).all()) or abs(float(split.sum()) - 1.0) > 1e-4
        gap = max(abs(float(e_got - e_ref)) / float(e_ref),
                  abs(float(v_got - v_ref)) / float(e_ref) ** 2)
        out["frontier_gap"] = max(out["frontier_gap"], np.inf if bad else gap)
        e_best = float(ref.expected_makespan(ref.solve(units, **solve), units, points))
        if control:
            split = ref.solve(units, **solve, dtype=dtype)
            e_ref = ref.expected_makespan(split, units, points)
        out["solve_gap"] = max(out["solve_gap"],
                               np.inf if bad else (float(e_ref) - e_best) / e_best)
        log(f"split {j}: the {ref.candidate(split, units, sc.min_fraction)} candidate, "
            f"E {float(e_ref):.6g} against the reference solve's {e_best:.6g}")
    quantized = samples["quantized"]
    for q in sorted(pick.choice(len(quantized), size=min(mix["check"]["quantized"], len(quantized)),
                                replace=False)):
        j, counts = quantized[q]
        split = np.asarray(splits[j][1], np.float64)
        if control:
            counts = ref.round_counts(split.astype(np.float32), total, dtype=np.float32)
        want = ref.round_counts(split, total)
        out["counts_off"] = max(out["counts_off"], np.abs(counts - want).sum() / (2.0 * total))
    return {n: float(v) for n, v in out.items()}
