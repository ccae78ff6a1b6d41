#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
result lines:

  1. environment: the card's name and power limit, torch and CUDA versions,
     TF32 off;
  2. build: every CUDA kernel of the port (K1 posterior grid, K2 decode
     attention, K3 linear-recurrence scan), from ``src/repro_torch/kernels/csrc``,
     into ``build/kernels`` (one ``nvcc`` per source, all started together),
     with ptxas's registers and spills of every entry function;
  3. each kernel against its plain PyTorch version on the card, at odd
     shapes, at the reference kernel tests' shapes and at the shapes the main
     paths give it: K1 in both its modes (mirrored and general), K2 at every
     compiled (G, D) and with a sequence of length 0;
  4. each kernel's device time at its main path's shape (median of
     CUDA-event-timed replays of a CUDA graph of repeated calls), its plain
     version's time, its bound, for K1 the general mode's time and the
     special-function floor, and for K2 the time of
     ``scaled_dot_product_attention`` on the same inputs;
  5. the paper's two-unit quickstart on the card: parameter recovery and f*
     per objective;
  6. the fleet cycle, slice 1's main path: K = 4096 heterogeneous workers, 3
     cycles of observe (N = 256) -> propose -> quantize (8 K microbatches),
     observe and propose under ``torch.cuda.set_sync_debug_mode("error")``;
     K1 launches (3 x 20, mirrored mode), finite fractions summing to 1, counts summing to
     the total, and the share of the oracle's gain over the uniform split that
     the learned split recovers (>= 80 %);
  7. serving, slice 2's main path: recurrentgemma-2b at full width (bf16
     parameters from seed 0) through ``repro_torch.launch.serve.latency_demo``,
     batch 4, 4096-token random prompts, 32 greedy tokens, float32 cache;
     prefill and decode times, peak device memory, K3 launches (18, one per
     RG-LRU layer of the prefill), K2 launches (8 x 31, one per attention
     layer of each decode step) and finite logits;
  8. teacher forcing at full width: the same model in float32, prefill of
     2100 tokens (past the 2048-token window) and 3 teacher-forced decode
     steps against ``forward_train``'s logits (rtol 2e-2, atol 2e-3, as
     tests/test_models.py).

Then three result lines: a JSON object with every kernel's route, source,
launches on its main path, error against its plain version, times, bound
and library time; the card's name and power limit as ``nvidia-smi`` gives
them; and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it fails.
"""
from __future__ import annotations

import itertools
import json
import re
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
    """Build every kernel; print what ptxas says of each entry function
    (its name, registers, spills), as it says it."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    say(f"[build] {sorted(build.launch_counts())} built in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for name in sorted(build.launch_counts()):
        for line in build.ptxas_report(name).splitlines():
            if re.search(r"Compiling entry function|spill stores|Used \d+ registers", line):
                say(f"[build] {name}: {line.strip()}")


def phase_k1_parity():
    """K1 in both modes against its plain version in the same form, at odd and
    main-path shapes; the grid is a symmetric linspace, as the mirrored mode
    needs."""
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
    for i, ((k, g, n, zc, dead), sym) in enumerate(itertools.product(shapes, (True, False))):
        args = fleet_case(k, g, n, seed=i // 2, device="cuda", zero_cols=zc, dead_worker=dead)
        got = posterior_grid_fleet(*args, symmetric_grid=sym)
        want = posterior_grid_plain(*args, symmetric_grid=sym)
        torch.cuda.synchronize()
        err = assert_logp_close(got, want)
        worst = max(worst, err)
        say(f"[k1-parity] {'mirrored' if sym else 'general '} K={k} G={g} N={n} "
            f"zero_cols={zc} dead_worker={dead}: max|err| {err:.3e} within rtol {RTOL:g} * "
            f"(1 + max|logp| = {1 + float(want.abs().max()):.3e})")
    return worst


def assert_close(got, want, rtol, atol) -> float:
    """|got - want| <= atol + rtol * |want| everywhere, as
    np.testing.assert_allclose; returns max |err|."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(f"disagrees: max|err| {float(err.max()):.3e} > {atol:g} + {rtol:g} |want|")
    return float(err.max())


# K2 at the serving path's decode: recurrentgemma-2b's local attention over a
# full window (B 4, H 10, KVH 1, D 256, S 2048), bfloat16 q, float32 cache.
K2_PATH = (4, 10, 1, 256, 2048)
# K3 at the serving path's prefill: B 4, T 4096, R 2560, float32.
K3_PATH = (4, 4096, 2560)


def decode_case(b, h, kvh, d, s, seed, q_dtype, kv_dtype, length=None):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    q, k, v = rn(b, h, d).to(q_dtype), rn(b, s, kvh, d).to(kv_dtype), rn(b, s, kvh, d).to(kv_dtype)
    if length is None:
        length = torch.randint(1, s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    else:
        length = torch.as_tensor(length, dtype=torch.int32, device="cuda")
    return q, k, v, length


def scan_case(b, t, r, seed, dtype):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    return torch.sigmoid(rn(b, t, r)).to(dtype), rn(b, t, r).to(dtype), rn(b, r).to(dtype)


def phase_k2_parity():
    """K2 against its plain version: tests/test_kernels.py's shapes in both
    types, the empty tail, a sequence of length 0, one case for each compiled
    (G, D), and the serving path's shape with lengths 1 and S."""
    import torch
    from repro_torch.kernels.decode_attention import (
        INSTANTIATED,
        decode_attention,
        decode_attention_plain,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((b, h, kvh, d, s), dt, dt, None, 2e-5 if dt == f32 else 2e-2)
             for (b, h, kvh, d, s) in [(2, 8, 2, 64, 300), (1, 4, 4, 32, 128), (3, 9, 3, 16, 1000)]
             for dt in (f32, bf16)]
    cases.append(((2, 4, 1, 32, 2048), f32, f32, [5, 17], 1e-5))  # empty tail
    cases.append(((3, 8, 2, 64, 500), f32, f32, [0, 130, 500], 2e-5))  # an empty cache
    for j, (g, d) in enumerate(sorted(INSTANTIATED)):  # every instantiation, types in turn
        q_dt, kv_dt = [(f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16)][j % 4]
        cases.append(((2, 2 * g, 2, d, 300), q_dt, kv_dt, [0, 300] if j % 2 else [77, 1],
                      2e-5 if q_dt == kv_dt == f32 else 2e-2))
    s = K2_PATH[-1]
    cases.append((K2_PATH, bf16, f32, [1, s, 1000, s - 1], 2e-2))  # the serving path
    cases.append((K2_PATH, f32, f32, [1, s, 1000, s - 1], 2e-5))  # its teacher-forced check
    worst = 0.0
    for i, (shape, q_dt, kv_dt, length, tol) in enumerate(cases):
        args = decode_case(*shape, seed=100 + i, q_dtype=q_dt, kv_dtype=kv_dt, length=length)
        got = decode_attention(*args)
        want = decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = assert_close(got, want, tol, tol)
        worst = max(worst, err)
        say(f"[k2-parity] (B, H, KVH, D, S)={shape} q {q_dt} cache {kv_dt} "
            f"lengths {args[3].tolist()}: max|err| {err:.3e} within {tol:g}")
    return worst


def phase_k3_parity():
    """K3 against its plain version: tests/test_kernels.py's shapes in both
    types, the continuation case, and the serving path's prefill shape."""
    import torch
    from repro_torch.kernels.lru_scan import lru_scan, lru_scan_plain

    f32, bf16 = torch.float32, torch.bfloat16
    worst = 0.0
    cases = [((b, t, r), dt, 1e-5 if dt == f32 else 4e-2)
             for (b, t, r) in [(2, 64, 128), (1, 100, 300), (3, 17, 64)] for dt in (f32, bf16)]
    cases.append((K3_PATH, f32, 1e-5))
    for i, (shape, dt, tol) in enumerate(cases):
        a, x, h0 = scan_case(*shape, seed=200 + i, dtype=dt)
        got = lru_scan(a, x, h0)
        want = lru_scan_plain(a, x, h0)
        torch.cuda.synchronize()
        err = assert_close(got, want, tol, tol)
        worst = max(worst, err)
        say(f"[k3-parity] (B, T, R)={shape} {dt}: max|err| {err:.3e} within {tol:g}")
    # continuation: [0:k] then [k:] from the carried state equals one pass
    a, x, _ = scan_case(2, 48, 64, seed=300, dtype=f32)
    h0 = torch.zeros((2, 64), device="cuda")
    full = lru_scan(a, x, h0)
    first = lru_scan(a[:, :20], x[:, :20], h0)
    second = lru_scan(a[:, 20:], x[:, 20:], first[:, -1])
    err = assert_close(second, full[:, 20:], 1e-5, 1e-5)
    worst = max(worst, err)
    say(f"[k3-parity] continuation (2, 48, 64) split at 20: max|err| {err:.3e} within 1e-05")
    return worst


def time_cuda(fn, runs: int, reps: int = 10) -> float:
    """Median device milliseconds of one ``fn`` call: ``reps`` calls captured
    in a CUDA graph (after a warm-up on a side stream), the graph replayed
    ``runs`` times between CUDA events.  Replay leaves out the host's launch
    overhead, which the port's eager callers still pay (PERF.md)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(ops: float, nbytes: float, peak_ops: float):
    """The least time for ``ops`` operations and ``nbytes`` bytes: (ms, which binds)."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    return float(out[0]) * 1e6


def phase_k1_timing():
    """K1 at the fleet cycle's observe shape: the mirrored mode, which the
    Gibbs sweep runs, is the kernel's time; the general mode's is printed
    first, on a line of its own."""
    import torch
    from repro_torch.kernels.posterior_grid import posterior_grid_fleet, posterior_grid_plain

    k, g, n = K_FLEET, GRID, N_OBS
    args = fleet_case(k, g, n, seed=7, device="cuda")
    general_ms = time_cuda(lambda: posterior_grid_fleet(*args), runs=30)
    ms = time_cuda(lambda: posterior_grid_fleet(*args, symmetric_grid=True), runs=30)
    plain_ms = time_cuda(lambda: posterior_grid_plain(*args, symmetric_grid=True), runs=5, reps=3)
    # Float32 operations per (k, g, n) cell of the mirrored mode: g * log2 f,
    # the exp2, pg * pg and three fused multiply-adds (two each), 9 in all.
    # The general mode adds a reciprocal: 10.
    # Bytes: t, f, mask, the per-worker scalars and the grid read once, the
    # (K, 2, G) output written.
    ops, general_ops = 9.0 * k * g * n, 10.0 * k * g * n
    nbytes = 4.0 * (3 * k * n + 8 * k + g + 2 * k * g)
    bound_ms, bound_by = bound(ops, nbytes, PEAK_F32_FLOPS)
    general_bound_ms, general_bound_by = bound(general_ops, nbytes, PEAK_F32_FLOPS)
    # One exp2 per cell on the special-function units: 16 a clock on each SM.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    sfu_ms = k * g * n / (sms * 16 * clock) * 1e3
    say(f"[k1-time] K={k} G={g} N={n}: general mode {general_ms:.4f} ms, bound "
        f"{general_bound_ms:.4f} ms by {general_bound_by} ({general_ops:.3e} ops)")
    say(f"[k1-time] K={k} G={g} N={n}: mirrored mode {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes), "
        f"special-function floor {sfu_ms:.4f} ms ({k * g * n:.3e} exp2 on {sms} SMs x 16 "
        f"at {clock / 1e9:.3f} GHz); no single library call computes this function")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def round_robin(fn, cases):
    """A call of ``fn`` on the next input set of ``cases``, in turn."""
    it = itertools.cycle(cases)
    return lambda: fn(*next(it))


def phase_k2_timing():
    """K2 at the serving path's decode shape, every cache row valid.  Calls
    take four input sets in turn (67 MB, more than the 50 MB L2), so the cache
    comes from device memory as in a decode step, where 25 other layers'
    weights and caches pass through L2 between two visits of one layer."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain

    b, h, kvh, d, s = K2_PATH
    cases = [decode_case(*K2_PATH, seed=7 + i, q_dtype=torch.bfloat16, kv_dtype=torch.float32,
                         length=[s] * b) for i in range(4)]
    ms = time_cuda(round_robin(decode_attention, cases), runs=30, reps=20)
    plain_ms = time_cuda(round_robin(decode_attention_plain, cases), runs=30, reps=20)
    # The library yardstick: SDPA on the same q, k, v (q in the cache's type,
    # heads first) with a boolean length mask.
    sdpa_cases = [(q.float()[:, :, None, :], k.transpose(1, 2).contiguous(),
                   v.transpose(1, 2).contiguous(),
                   (torch.arange(s, device="cuda")[None, :] < n[:, None])[:, None, None, :])
                  for q, k, v, n in cases]
    sdpa = lambda q4, k4, v4, mask: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True)
    library_ms = time_cuda(round_robin(sdpa, sdpa_cases), runs=30, reps=20)
    q, k, _, length = cases[0]
    # 2 operations per multiply-add: q.k and p.v over every valid row and head
    ops = 4.0 * b * h * s * d
    nbytes = (q.numel() * 2 + 2 * k.numel() * 4 + length.numel() * 4 + q.numel() * 2)
    bound_ms, bound_by = bound(ops, nbytes, PEAK_F32_FLOPS)
    say(f"[k2-time] (B, H, KVH, D, S)={K2_PATH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({ops:.3e} ops, {nbytes:.3e} bytes)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_k3_timing():
    """K3 at the serving path's prefill shape."""
    from repro_torch.kernels.lru_scan import lru_scan, lru_scan_plain
    import torch

    b, t, r = K3_PATH
    a, x, h0 = scan_case(*K3_PATH, seed=7, dtype=torch.float32)
    ms = time_cuda(lambda: lru_scan(a, x, h0), runs=20)
    plain_ms = time_cuda(lambda: lru_scan_plain(a, x, h0), runs=5, reps=3)
    ops = 2.0 * b * t * r  # one multiply-add per element
    nbytes = 4.0 * (3 * b * t * r + b * r)  # a, b read, h written, h0 read
    bound_ms, bound_by = bound(ops, nbytes, PEAK_F32_FLOPS)
    say(f"[k3-time] (B, T, R)={K3_PATH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes); "
        f"no single library call computes a linear recurrence")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


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


SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "recurrentgemma-2b", 4, 4096, 32
TF_BATCH, TF_PREFILL, TF_STEPS = 2, 2100, 3
TF_TOL = dict(rtol=2e-2, atol=2e-3)  # tests/test_models.py's decode-vs-teacher-forcing


def phase_serve():
    """Slice 2's main path: serve recurrentgemma-2b at full width."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import latency_demo
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx
    from repro_torch.models.params import leaves

    cfg = get_arch(SERVE_ARCH)
    params = model_zoo.init_model_params(cfg, seed=0)
    n_params = sum(p.numel() for p in leaves(params))
    say(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B parameters in {cfg.dtype}, "
        f"{cfg.num_layers} layers of pattern {cfg.pattern}")
    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT)
    warm = latency_demo(cfg, params, gen_len=2, **kw)  # CUDA and cuBLAS set-up, same shapes
    say(f"[serve] warm-up (prefill + 1 step): prefill {warm['prefill_ms']:.1f} ms")
    del warm
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = latency_demo(cfg, params, gen_len=SERVE_GEN, **kw)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = out["tokens"]
    # the logits of one more step on the final cache: finite and of the vocabulary's width
    logits, _ = model_zoo.decode_step(cfg, params, tokens[:, -1:], out["cache"],
                                      ctx=ApplyCtx(mode="decode"))
    if logits.shape != (SERVE_BATCH, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or misshapen")
    if tokens.shape != (SERVE_BATCH, SERVE_GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generated tokens {tuple(tokens.shape)} out of shape or range")
    say(f"[serve] batch {SERVE_BATCH} prompt {SERVE_PROMPT} gen {SERVE_GEN}: prefill "
        f"{out['prefill_ms']:.1f} ms, decode {out['decode_ms']:.2f} ms/token, peak device "
        f"memory {peak / 2**30:.2f} GiB, logits finite")
    say(f"[serve] generated token ids (seq 0): {tokens[0].tolist()}")
    say(f"[serve] launches on the main path: {launches}")
    return launches


def phase_teacher_forcing():
    """Prefill past the window, then teacher-forced decode steps, against the
    full-sequence forward, all at full width in float32."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx
    from repro_torch.models.params import tree_map

    cfg = get_arch(SERVE_ARCH)
    params = tree_map(lambda t: t.float(), model_zoo.init_model_params(cfg, seed=0))
    total = TF_PREFILL + TF_STEPS
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TF_BATCH, total)),
                           dtype=torch.int32, device=params["embed"].device)
    full, _ = model_zoo.forward_train(cfg, params, {"tokens": toks}, ctx=ApplyCtx(mode="train"))
    want = full[:, TF_PREFILL - 1:].clone()  # (B, 1 + steps, V)
    del full
    cache = model_zoo.init_cache(cfg, TF_BATCH, total + 8, torch.float32)
    got, cache = model_zoo.prefill(cfg, params, {"tokens": toks[:, :TF_PREFILL]}, cache,
                                   ctx=ApplyCtx(mode="prefill"))
    steps = [got]
    for j in range(TF_PREFILL, total):
        got, cache = model_zoo.decode_step(cfg, params, toks[:, j:j + 1], cache,
                                           ctx=ApplyCtx(mode="decode"))
        steps.append(got)
    worst = 0.0
    for i, got in enumerate(steps):
        err = assert_close(got, want[:, i], **TF_TOL)
        worst = max(worst, err)
        what = "prefill" if i == 0 else f"decode step {i}"
        say(f"[teacher] {what} (position {TF_PREFILL - 1 + i}): max|err| {err:.3e} against "
            f"forward_train, max|logit| {float(want[:, i].abs().max()):.3f}")
    say(f"[teacher] {cfg.name} float32, batch {TF_BATCH}, prefill {TF_PREFILL} > window "
        f"{cfg.local_window}, {TF_STEPS} decode steps: within rtol {TF_TOL['rtol']} "
        f"atol {TF_TOL['atol']}, worst {worst:.3e}")
    return worst


def main() -> int:
    card = phase_environment()
    phase_build()
    import torch
    from repro_torch.configs import get_arch

    errs = dict(posterior_grid_fleet=phase_k1_parity(), decode_attention=phase_k2_parity(),
                lru_scan=phase_k3_parity())
    timing = dict(posterior_grid_fleet=phase_k1_timing(), decode_attention=phase_k2_timing(),
                  lru_scan=phase_k3_timing())
    phase_quickstart()
    fleet_launches, gap = phase_fleet()
    expected = CYCLES * SWEEPS
    if fleet_launches.get("posterior_grid_fleet") != expected:
        raise AssertionError(f"K1 launched {fleet_launches} times on the fleet path, not {expected}")
    if gap < 0.8:
        raise AssertionError(f"oracle gap recovered {100 * gap:.1f} % < 80 %")
    serve_launches = phase_serve()
    cfg = get_arch(SERVE_ARCH)
    n = len(cfg.pattern)
    kinds = cfg.pattern * (cfg.num_layers // n) + cfg.pattern[: cfg.num_layers % n]
    want = dict(lru_scan=kinds.count("rglru"),  # once per RG-LRU layer of the prefill
                decode_attention=kinds.count("localattn") * (SERVE_GEN - 1))  # per decode step
    for name, n in want.items():
        if serve_launches.get(name) != n:
            raise AssertionError(f"{name} launched {serve_launches.get(name)} times in serving, not {n}")
    phase_teacher_forcing()
    launches = dict(posterior_grid_fleet=fleet_launches["posterior_grid_fleet"],
                    decode_attention=serve_launches["decode_attention"],
                    lru_scan=serve_launches["lru_scan"])
    kernels = [
        ("posterior_grid_fleet", "posterior_grid.cu", "src/repro/kernels/posterior_grid.py:108"),
        ("decode_attention", "decode_attention.cu", "src/repro/kernels/decode_attention.py:81"),
        ("lru_scan", "lru_scan.cu", "src/repro/kernels/lru_scan.py:52"),
    ]
    say(json.dumps({"kernels": [dict(
        name=name,
        route="cuda",
        source=f"src/repro_torch/kernels/csrc/{source}",
        replaces=replaces,
        launches=launches[name],
        max_abs_err=errs[name],
        **timing[name],
    ) for name, source, replaces in kernels]}))
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
