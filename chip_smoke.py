#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
last line:

  1. environment: the card's name and power limit, torch and CUDA versions,
     TF32 off;
  2. build: every CUDA kernel of the port, from ``src/repro_torch/kernels/csrc``,
     into ``build/kernels`` (one ``nvcc`` per source, all started together);
  3. each kernel against its plain PyTorch version on the card, at odd
     shapes and at the shapes the main path gives it;
  4. each kernel's time at the main path's shape (median of CUDA-event runs
     after warm-up), its plain version's time and its bound;
  5. the paper's two-unit quickstart on the card: parameter recovery and f*
     per objective;
  6. the fleet cycle, the main path: K = 4096 heterogeneous workers, 3 cycles
     of observe (N = 256) -> propose -> quantize (8 K microbatches), observe
     and propose under ``torch.cuda.set_sync_debug_mode("error")``; kernel
     launch counts, finite fractions summing to 1, counts summing to the
     total, and the share of the oracle's gain over the uniform split that
     the learned split recovers (>= 80 %).

The line before the last is a JSON object with every kernel's launches,
error and times; the last is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside a checkout of the repository, it fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "examples"))

# The card's published peaks (H100 SXM data sheet): float32 outside the
# tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

K_FLEET, N_OBS, GRID, SWEEPS, CYCLES = 4096, 256, 256, 20, 3
RTOL = 2e-5  # the reference kernel tests' _assert_logp_close


def say(*parts) -> None:
    print(*parts, flush=True)


def assert_logp_close(got, want, rtol=RTOL) -> float:
    """rtol scaled by 1 + max|want| (tests/test_kernels.py); returns max |err|."""
    import torch

    scale = 1.0 + float(want.abs().max())
    err = (got - want).abs()
    bound = rtol * scale + rtol * want.abs()
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"kernel disagrees: max|err| {float(err.max()):.3e}, "
                             f"bound {rtol:g} * (1 + max|want| = {scale:.3e})")
    return float(err.max())


def fleet_case(k, g, n, seed, device, zero_cols=False, dead_worker=False):
    """Kernel inputs shaped as the reference kernel tests' _fleet_case."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen, device=device)
    lin = lambda a, b: torch.linspace(a, b, k, device=device)
    f = 0.05 + 0.9 * u(k, n)
    mu = lin(5.0, 40.0)
    noise = torch.randn((k, n), generator=gen, device=device)
    t = f**0.9 * mu[:, None] + f**0.7 * 2.0 * noise
    cols = torch.arange(n, device=device)
    mask = (cols[None, :] < torch.linspace(n // 2, n, k, device=device)[:, None]).float()
    if zero_cols:
        mask = mask * (cols % 5 != 0).float()[None, :]
    if dead_worker:
        mask[k // 2] = 0.0
    grid = torch.linspace(1e-4, 1 - 1e-4, g, device=device)
    return (grid, t, f, mask, mu, lin(0.1, 0.5), lin(0.6, 0.95), lin(0.5, 0.9),
            lin(1.5, 4.0), lin(2.0, 3.0), lin(2.0, 5.0), lin(1.5, 2.5))


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    say(f"[build] {sorted(build.launch_counts())} built in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR.relative_to(ROOT)}")


def phase_kernel_parity():
    """K1 against its plain version at odd and main-path shapes."""
    import torch
    from repro_torch.kernels.posterior_grid import posterior_grid_fleet, posterior_grid_plain

    shapes = [  # (k, g, n, zero_cols, dead_worker)
        (5, 17, 33, True, False),
        (3, 300, 777, True, True),
        (4, 512, 128, False, True),
        (1, GRID, 64, False, False),  # the quickstart's single unit, one batch
        (K_FLEET, GRID, N_OBS, False, False),  # the fleet cycle's observe
    ]
    worst = 0.0
    for i, (k, g, n, zc, dead) in enumerate(shapes):
        args = fleet_case(k, g, n, seed=i, device="cuda", zero_cols=zc, dead_worker=dead)
        got = posterior_grid_fleet(*args)
        want = posterior_grid_plain(*args)
        torch.cuda.synchronize()
        err = assert_logp_close(got, want)
        worst = max(worst, err)
        say(f"[k1-parity] K={k} G={g} N={n} zero_cols={zc} dead_worker={dead}: "
            f"max|err| {err:.3e} within rtol {RTOL:g} * (1 + max|logp| = "
            f"{1 + float(want.abs().max()):.3e})")
    return worst


def time_cuda(fn, runs: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel_timing():
    from repro_torch.kernels.posterior_grid import posterior_grid_fleet, posterior_grid_plain

    k, g, n = K_FLEET, GRID, N_OBS
    args = fleet_case(k, g, n, seed=7, device="cuda")
    ms = time_cuda(lambda: posterior_grid_fleet(*args), runs=30)
    plain_ms = time_cuda(lambda: posterior_grid_plain(*args), runs=10)
    # ~10 float32 operations per (k, g, n) cell (exp and reciprocal counted
    # as one each, a fused multiply-add as two); bytes: t, f, mask, the
    # per-worker scalars and the grid read once, the (K, 2, G) output written.
    ops = 10.0 * k * g * n
    nbytes = 4.0 * (3 * k * n + 8 * k + g + 2 * k * g)
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    say(f"[k1-time] K={k} G={g} N={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes); "
        f"no single library call computes this function")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_quickstart():
    import quickstart_torch as qs

    t0 = time.perf_counter()
    st_i, st_j = qs.learn("cuda")
    _, choices = qs.frontier_choices(st_i, st_j)
    # tests/test_gibbs.py's recovery thresholds
    limits = dict(mu=1.5, sigma=1.0, alpha=0.08, beta=0.15)
    for name, st in (("i", st_i), ("j", st_j)):
        learned = {p: float(getattr(st, p)) for p in limits}
        say(f"[quickstart] unit {name} learned "
            + " ".join(f"{p}={v:.3f}" for p, v in learned.items())
            + " true " + " ".join(f"{p}={qs.TRUE[name][p]}" for p in limits))
        for p, lim in limits.items():
            if not abs(learned[p] - qs.TRUE[name][p]) < lim:
                raise AssertionError(f"unit {name}: {p} not recovered within {lim}")
    for obj, f_opt, m, v in choices:
        say(f"[quickstart] objective={obj:11s} f*={f_opt:.3f} E[t]={m:.2f} Var[t]={v:.2f}")
    say(f"[quickstart] ok in {time.perf_counter() - t0:.2f} s")


def phase_fleet(device="cuda", k=K_FLEET, n=N_OBS):
    """The main path: observe -> propose -> quantize on a seeded fleet.

    ``device="cpu"`` with a small ``k`` and ``n`` rehearses it without a
    card (no sync check, no device clocks)."""
    import contextlib

    import torch
    from repro_torch import kernels, sched
    from repro_torch.core.frontier import UnitParams

    total = 8 * k
    # The proposal floor matches quantization's one-microbatch floor.
    config = sched.SchedulerConfig(min_fraction=1.0 / total)
    gen = torch.Generator(device=device).manual_seed(2015)
    u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(shape or (k,), generator=gen, device=device)
    truth = UnitParams(mu=u(5.0, 40.0), sigma=u(0.5, 3.0), alpha=u(0.6, 0.95), beta=u(0.5, 0.9))

    def telemetry(fracs):
        # each worker runs n jobs whose sizes vary by e^[-2, 2] around its
        # share: proposals move shares by up to ~16x, and alpha is only
        # identified across the range the telemetry spans
        f = fracs[:, None] * torch.exp(u(-2.0, 2.0, k, n))
        eps = torch.randn((k, n), generator=gen, device=device)
        t = f ** truth.alpha[:, None] * truth.mu[:, None] + f ** truth.beta[:, None] * truth.sigma[:, None] * eps
        return sched.Telemetry(fracs=f, times=t)

    def no_sync():
        if device == "cpu":
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def guard():
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return guard()

    def clock(fn):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    state = sched.init(config, k, seed=0, device=device)
    fracs = torch.full((k,), 1.0 / k, device=device)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for c in range(CYCLES):
        telem = telemetry(fracs)

        def observe_and_propose():
            with no_sync():
                st, ll = sched.observe(state, telem, config)
                fr, stats = sched.propose(st, config)
            return st, ll, fr, stats

        (state, ll, fracs, stats), ms_cycle = clock(observe_and_propose)
        counts, ms_quant = clock(lambda: sched.quantize_fractions(
            fracs.cpu().numpy(), total, sched.unit_params(state), objective=config.objective))
        if not bool(torch.isfinite(ll).all()):
            raise AssertionError("non-finite log-likelihood")
        if not (bool(torch.isfinite(fracs).all()) and abs(float(fracs.sum()) - 1.0) < 1e-4):
            raise AssertionError(f"fractions not finite or sum {float(fracs.sum())} != 1")
        if counts.sum() != total or counts.min() < 1:
            raise AssertionError(f"counts sum {counts.sum()} != {total} or below the floor")
        say(f"[fleet] cycle {c}: observe+propose {ms_cycle:.1f} ms (sync-free), "
            f"quantize {ms_quant:.1f} ms, E[t] {float(stats.e_t):.5f}")
    launches = kernels.launch_counts()

    # Separate timings of the two device stages on the final state.
    telem = telemetry(fracs)
    _, ms_observe = clock(lambda: sched.observe(state, telem, config))
    _, ms_propose = clock(lambda: sched.propose(state, config))

    uniform = torch.full((k,), 1.0 / k, device=device)
    oracle, _ = sched.solve_fractions(
        truth, objective=config.objective, steps=config.opt_steps, lr=config.opt_lr,
        num_points=config.num_points, min_fraction=config.min_fraction)
    score = lambda fr: float(sched.evaluate(config.objective, fr, truth, num_points=config.num_points))
    s_uni, s_prop, s_orc = score(uniform), score(fracs), score(oracle)
    gap = (s_uni - s_prop) / max(s_uni - s_orc, 1e-12)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    say(f"[fleet] K={k} N={n}: observe {ms_observe:.1f} ms, propose {ms_propose:.1f} ms, "
        f"quantize (last cycle) {ms_quant:.1f} ms, peak device memory {peak / 2**20:.1f} MiB")
    say(f"[fleet] E[t] under the truth: uniform {s_uni:.5f}, proposed {s_prop:.5f}, "
        f"oracle {s_orc:.5f}: oracle gap recovered {100 * gap:.1f} %")
    say(f"[fleet] launches on the main path: {launches}")
    return launches, gap


def main() -> int:
    card = phase_environment()
    phase_build()
    import torch

    err = phase_kernel_parity()
    timing = phase_kernel_timing()
    phase_quickstart()
    launches, gap = phase_fleet()
    expected = CYCLES * SWEEPS
    if launches.get("posterior_grid_fleet") != expected:
        raise AssertionError(f"K1 launched {launches} times on the main path, not {expected}")
    if gap < 0.8:
        raise AssertionError(f"oracle gap recovered {100 * gap:.1f} % < 80 %")
    say(json.dumps({"kernels": [dict(
        name="posterior_grid_fleet",
        route="cuda",
        source="src/repro_torch/kernels/csrc/posterior_grid.cu",
        replaces="src/repro/kernels/posterior_grid.py:108",
        launches=launches["posterior_grid_fleet"],
        max_abs_err=err,
        library_ms=None,
        **timing,
    )]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — report any phase's failure and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        sys.exit(1)
