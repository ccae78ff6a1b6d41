"""Plain reference of the estimation service's arithmetic (arXiv:1511.00613).

Written from the paper's equations in plain PyTorch; it imports nothing of
the program.  Every function computes in ``dtype`` (float32 by default: the
precision the configuration states) and returns float32, so the same code in
bfloat16 is the check's control.

  * ``discount``: power-prior forgetting of a worker's prior before a batch;
  * ``normal_gamma``: the conjugate update of (mu, lambda), Eqs 6-9;
  * ``exponent_posteriors``: log p(alpha | .) and log p(beta | .) on the
    exponent grid, Eqs 10-11, in their direct (unexpanded) form;
  * ``beta_fit``: moments by the trapezoid rule (Eqs 16-18), then the Beta
    fit by the method of moments (Eqs 12-15), with the port's clamps;
  * ``makespan_moments``: E and Var of max_k t_k under a split, by
    quadrature of the survival function, t_k ~ N(f^alpha mu, (f^beta sigma)^2);
  * ``solve``: the split that minimises it (bisection start, Adam on logits,
    the best of refined, equalizing and uniform);
  * ``candidate``: which of the solve's three candidates a split is;
  * ``round_counts``: largest-remainder rounding to integer counts with a
    floor of one a worker.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

F32 = torch.float32


class NG(NamedTuple):
    mu0: Tensor
    kappa0: Tensor
    nu0: Tensor
    psi0: Tensor


class Units(NamedTuple):
    mu: Tensor
    sigma: Tensor
    alpha: Tensor
    beta: Tensor


def _in(dtype, *xs):
    return [torch.as_tensor(x).to(dtype) for x in xs]


def discount(ng: NG, ap, bp, rho: float, dtype=F32):
    """Scale the pseudo-counts by rho; Beta priors (a - 1) rho + 1."""
    mu0, kappa0, nu0, psi0, a_a, a_b, b_a, b_b = _in(dtype, *ng, *ap, *bp)
    out = (mu0, kappa0 * rho, torch.clamp(nu0 * rho, min=0.51), psi0 * rho,
           (a_a - 1) * rho + 1, (a_b - 1) * rho + 1, (b_a - 1) * rho + 1, (b_b - 1) * rho + 1)
    out = [x.float() for x in out]
    return NG(*out[:4]), (out[4], out[5]), (out[6], out[7])


def normal_gamma(prior: NG, t, f, alpha, beta, mask, dtype=F32) -> NG:
    """Eqs 6-9 with alpha, beta fixed: t_n ~ N(f_n^alpha mu, f_n^(2 beta) / lambda)."""
    mu0, kappa0, nu0, psi0 = _in(dtype, *prior)
    t, f, m, alpha, beta = _in(dtype, t, f, mask, alpha, beta)
    f = torch.clamp(f, min=1e-6)
    a, b = alpha[:, None], beta[:, None]
    x = f ** (a - b)            # the mean's regressor, after dividing by f^beta
    y = t / f ** b
    kappa = kappa0 + (m * x * x).sum(-1)
    mu = (mu0 * kappa0 + (m * x * y).sum(-1)) / kappa
    nu = nu0 + 0.5 * m.sum(-1)
    psi = psi0 + 0.5 * ((m * y * y).sum(-1) + mu0 * mu0 * kappa0 - mu * mu * kappa)
    psi = torch.clamp(psi, min=1e-8)
    return NG(*(v.float() for v in (mu, kappa, nu, psi)))


def exponent_grid(g: int, device=None) -> Tensor:
    return torch.linspace(1e-4, 1.0 - 1e-4, g, dtype=F32, device=device)


def exponent_posteriors(grid, t, f, mu, lam, alpha, beta, ap, bp, mask, dtype=F32,
                        rows: int = 8192) -> Tensor:
    """(K, 2, G): row 0 log p(alpha = g | .), row 1 log p(beta = g | .), each
    up to a constant, in blocks of ``rows`` workers."""
    out = []
    g = torch.clamp(grid.to(dtype), 1e-6, 1 - 1e-6)
    lg, l1g = torch.log(g), torch.log1p(-g)
    for i in range(0, t.shape[0], rows):
        sl = slice(i, i + rows)
        tt, ff, mm = _in(dtype, t[sl], f[sl], mask[sl])
        ff = torch.clamp(ff, min=1e-6)
        mu_, lam_, al, be, a_a, a_b, b_a, b_b = (x[sl][:, None].to(dtype) for x in
                                                  (mu, lam, alpha, beta, *ap, *bp))
        pg = ff[:, None, :] ** g[None, :, None]                      # (k, G, N) = f^g
        ra = (tt[:, None, :] - pg * mu_[:, :, None]) / ff[:, None, :] ** be[:, :, None]
        qa = -0.5 * lam_ * (mm[:, None, :] * ra * ra).sum(-1)
        rb = (tt - ff ** al * mu_)[:, None, :] / pg
        qb = -0.5 * lam_ * (mm[:, None, :] * rb * rb).sum(-1)
        logf = (mm * torch.log(ff)).sum(-1, keepdim=True)
        la = qa + (a_a - 1) * lg + (a_b - 1) * l1g
        lb = qb - g * logf + (b_a - 1) * lg + (b_b - 1) * l1g
        out.append(torch.stack([la, lb], dim=1).float())
    return torch.cat(out)


def beta_fit(grid, logp, dtype=F32):
    """(a, b) of the Beta matched to the grid density's mean and variance."""
    grid, logp = _in(dtype, grid, logp)
    h = 0.5 * (grid[1:] - grid[:-1])
    w = torch.cat([h, h[-1:] * 0]) + torch.cat([h[:1] * 0, h])   # trapezoid weights
    p = torch.exp(logp - logp.amax(-1, keepdim=True))
    p = p / torch.clamp((p * w).sum(-1, keepdim=True), min=1e-30)
    e1 = (p * w * grid).sum(-1)
    var = torch.clamp((p * w * grid * grid).sum(-1) - e1 * e1, min=1e-12)
    mean = torch.clamp(e1, 1e-4, 1 - 1e-4)
    cap = mean * (1 - mean)
    var = torch.minimum(torch.clamp(var, min=1e-10), 0.999 * cap)
    common = cap / var - 1
    return (torch.clamp(mean * common, min=1e-3).float(),
            torch.clamp((1 - mean) * common, min=1e-3).float())


def units_from_posterior(ng: NG, ap, bp) -> Units:
    """Point estimates: posterior mean of mu, 1/sqrt(E lambda), Beta means."""
    lam = ng.nu0 / torch.clamp(ng.psi0, min=1e-30)
    return Units(ng.mu0, 1 / torch.sqrt(torch.clamp(lam, min=1e-30)),
                 ap[0] / (ap[0] + ap[1]), bp[0] / (bp[0] + bp[1]))


# ---------------------------------------------------------------------------
# the completion-time frontier
# ---------------------------------------------------------------------------

def _log_ndtr(z: Tensor) -> Tensor:
    """log Phi(z) in z's type (bfloat16 rounds a float32 evaluation: the
    card has no bfloat16 kernel for it)."""
    return torch.special.log_ndtr(z.float()).to(z.dtype)


def makespan_moments(fracs: Tensor, p: Units, points: int = 512, dtype=F32):
    """E[max_k t_k] and Var[max_k t_k] for splits (..., K), by the trapezoid
    rule over the survival function on [0, max(mean + 8 sd)]."""
    fr, mu, sig, al, be = _in(dtype, fracs, *p)
    fr = torch.clamp(fr, min=1e-9)
    mean, sd = fr ** al * mu, torch.clamp(fr ** be * sig, min=1e-9)
    upper = torch.clamp((mean + 8 * sd).amax(-1), min=1e-6)
    eps = torch.linspace(0, 1, points, dtype=dtype, device=fr.device) * upper[..., None]
    z = (eps[..., :, None] - mean[..., None, :]) / torch.clamp(sd[..., None, :], min=1e-6)
    surv = 1 - torch.exp(_log_ndtr(z).sum(-1))
    e1 = torch.trapezoid(surv, eps, dim=-1)
    e2 = 2 * torch.trapezoid(eps * surv, eps, dim=-1)
    return e1.float(), torch.clamp(e2 - e1 * e1, min=0).float()


def expected_makespan(fracs: Tensor, p: Units, points: int = 512, dtype=F32) -> Tensor:
    return makespan_moments(fracs, p, points, dtype)[0]


def _equalizing(p: Units, dtype) -> Tensor:
    """Shares with equal expected times: sum_k (tau / mu_k)^(1/alpha_k) = 1."""
    log_mu = torch.log(torch.clamp(p.mu.to(dtype), min=1e-6))
    alpha = torch.clamp(p.alpha.to(dtype), 0.05, 1.0)
    share = lambda lt: torch.exp(torch.clamp((lt - log_mu) / alpha, -60.0, 0.0))
    hi = log_mu.amax()
    lo = hi - 60.0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        big = share(mid).sum() > 1.0
        lo, hi = torch.where(big, lo, mid), torch.where(big, mid, hi)
    f = share(0.5 * (lo + hi))
    return f / f.sum()


def solve(p: Units, *, steps: int, lr: float = 0.05, points: int = 512, min_fraction: float,
          dtype=F32) -> Tensor:
    """The split of least E[makespan]: from the equalizing shares, Adam on
    softmax logits of E[t], then the best of the refined,
    equalizing and uniform splits, each floored at ``min_fraction``."""
    p = Units(*(x.detach().to(dtype) for x in p))
    f_eq = _equalizing(p, dtype)
    k = f_eq.shape[0]
    logits = torch.log(torch.clamp(f_eq, min=1e-9))
    m, v = torch.zeros_like(logits), torch.zeros_like(logits)
    with torch.enable_grad():
        for step in range(1, steps + 1):
            x = logits.detach().requires_grad_(True)
            loss = expected_makespan(torch.softmax(x, -1), p, points, dtype)
            (g,) = torch.autograd.grad(loss.to(dtype), x)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            logits = logits - lr * (m / (1 - 0.9 ** step)) / (torch.sqrt(v / (1 - 0.999 ** step)) + 1e-8)
    cands = torch.stack([torch.softmax(logits, -1), f_eq, torch.full_like(f_eq, 1.0 / k)])
    cands = torch.clamp(cands, min=min_fraction)
    cands = cands / cands.sum(-1, keepdim=True)
    scores = expected_makespan(cands, p, points, dtype)
    return cands[int(torch.argmin(scores))].float()


def candidate(split: Tensor, p: Units, min_fraction: float) -> str:
    """"uniform", "equalizing" or "refined": the candidate of ``solve`` that
    ``split`` is, to a relative 1e-3 a share."""
    split = split.float()
    k = split.shape[-1]
    eq = torch.clamp(_equalizing(Units(*(x.float() for x in p)), F32), min=min_fraction)
    for name, want in (("uniform", torch.full_like(split, 1.0 / k)), ("equalizing", eq / eq.sum())):
        if bool(((split - want).abs() <= 1e-3 * want).all()):
            return name
    return "refined"


# ---------------------------------------------------------------------------
# integer counts
# ---------------------------------------------------------------------------

def _fill(priority: np.ndarray, cap: np.ndarray, need: int) -> np.ndarray:
    """Units taken one at a time from the highest priority_i - taken_i,
    taken_i <= cap_i, lower index first among equals (in priority's type)."""
    taken = np.zeros(len(priority), np.int64)
    if need <= 0:
        return taken
    lo, hi = float(priority.min() - cap.max() - 2.0), float(priority.max() + 1.0)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if np.clip(np.ceil(priority - mid), 0, cap).sum() >= need:
            lo = mid
        else:
            hi = mid
    taken = np.clip(np.ceil(priority - lo), 0, cap).astype(np.int64)
    surplus = int(taken.sum()) - need
    if surplus > 0:
        last = np.where(taken > 0, priority - taken + 1.0, np.inf)
        taken[np.argsort(last, kind="stable")[:surplus]] -= 1
    return taken


def round_counts(fracs: np.ndarray, total: int, min_per: int = 1,
                 dtype=np.float64) -> np.ndarray:
    """Largest-remainder rounding with a floor of ``min_per`` a worker,
    its arithmetic in ``dtype``."""
    raw = np.asarray(fracs, dtype) * dtype(total)
    counts = np.maximum(np.floor(raw).astype(np.int64), min_per)
    counts -= _fill((counts - raw).astype(dtype), counts - min_per, int(counts.sum()) - total)
    need = total - int(counts.sum())
    counts += _fill((raw - counts).astype(dtype), np.full(len(counts), max(need, 0)), need)
    return counts


def beta_moments(a: Tensor, b: Tensor):
    """Mean and standard deviation of Beta(a, b)."""
    a, b = a.double(), b.double()
    n = a + b
    return a / n, torch.sqrt(a * b / (n * n * (n + 1)))


def fit_gap(got, want, step: float) -> float:
    """The widest gap between two Beta fits' means or standard deviations,
    in grid steps: a worker whose posterior is narrower than the grid has
    an ill-conditioned variance, so its (a, b) themselves may differ by a
    large share while the distributions agree."""
    (gm, gs), (wm, ws) = beta_moments(*got), beta_moments(*want)
    return float(torch.maximum((gm - wm).abs(), (gs - ws).abs()).max()) / step


def relative_gap(got: Tensor, want: Tensor, floor_share: float = 1e-3) -> float:
    """max |got - want| / max(|want|, floor_share x the median |want|)."""
    got, want = got.float(), want.float()
    floor = floor_share * float(want.abs().median())
    den = torch.clamp(want.abs(), min=max(floor, 1e-30))
    return float(((got - want).abs() / den).max())
