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
     paths give it: K1 in both its modes (mirrored and general), the
     service's slab (2048, 512, 8) and dense drain (100 000, 512, 8) among
     them, K2 at every compiled (G, D) and with a sequence of length 0, K3
     at the ragged edges
     of its tiling, with decays near 1 (where every chunk's carry shows) and
     from rows that are not 16-byte aligned, and K3's output bitwise the
     same on two calls and on replays of a CUDA graph;
  4. each kernel's device time at its main path's shape (median of
     CUDA-event-timed replays of a CUDA graph of repeated calls), its plain
     version's time, its bound, for K1 the general mode's time and the
     special-function floor, for K2 the time of
     ``scaled_dot_product_attention`` on the same inputs, and for K3 the
     stream yardstick ``torch.add(a, x, out=h)``, which moves its bytes, and
     its time from rows that are not 16-byte aligned (plain loads, not TMA);
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
     tests/test_models.py);
  9. the always-on service at fleet scale, slice 5's main path (K = 100 000,
     G = 512, ring 8, 20 sweeps, active set M = 2048): (a) the active path
     at arange(K) bitwise the dense path (K = 4096, ``gibbs_batch`` and
     ``advance_fleet``), (b) K1's slab launch bitwise the dense launch and
     rows outside the index untouched, (c) ``select_active`` against a
     stable sort on the host, (d) every worker refreshed within ceil(K/M)
     ticks (K = 8192, M = 512), and the hierarchical, calibrated-gate
     service's ticks with no sync before the flag read, (e) dense and active ``ServiceLoop`` ticks
     with async propose, every advance under sync-debug "error", 20 K1
     launches a tick, no drops, flat device memory, with tick times, the
     async dispatch's host time, dispatch to publish and peak memory beside
     ``compression_report``, (f) a capacity state of 2 x 4096 slots through
     admit -> observe -> propose -> retire with no sync, dead slots getting
     exactly 0 of the proposal and of the quantized microbatches;
 7b. smollm-135m at full width through ``python -m repro_torch.launch.serve``
     with SMOLLM_ARGV (batch 4, 512-token prompts, 16 tokens), after a
     2-token warm-up: K2 launches (30 per decode step, (G, D) = (3, 64)),
     tokens in range, finite logits;
 10. partitioned serving at full width: ``repro_torch.launch.serve`` with
     PART_ARGV (recurrentgemma-2b, 16 rounds, 4 replicas, batch 16, 1024-token
     prompts, 16 tokens, a drain every 4 rounds, the drift gate at the
     reference smoke's 0.12), the reference's smoke
     condition (proposes >= 1, drains > proposes), finite published splits
     summing to 1, the oracle makespans, and K1, K2 and K3 launches; then
     each kernel against its plain version at the shapes this run gave it
     (K1 at the service's (replicas, G, ring), K3 at every prefill batch
     replica 0 served, K2 at those batches over the decode steps' lengths);
 11. the workflow DAG, slice 6's main path: 8 stages (0 -> {1, 2, 3} -> 4 ->
     {5, 6} -> 7; stage 2 conditional at p 0.3, stage 6 at 0.5, stage 3
     reworked at 0.4 up to 4 attempts, stage 5 at 0.2 up to 3, stage 7 256
     workers wide, the others K = 512: S K = 4096 estimated workers), 3
     cycles of ``observe_dag`` (N = 256) -> ``propose_dag`` (a variance
     budget of half the uniform split's) -> ``quantize_dag_fractions`` (8 K
     microbatches a stage, largest remainder), observe and propose under
     sync-debug "error";
     K1 against its plain version at the folded (8, 512, 256) block through
     the stacked entry, K1 launches (20 per ``observe_dag``), times of each
     step and of ``simulate_workflow`` at 2e5 samples, peak memory; the
     learned split against the uniform one on the simulator with common
     random numbers (asserted), the stochastic-aware against the
     deterministic-assumption split, the analytic composed moments against
     the simulator, and ``examples/pipeline_dag_torch.py``'s diamond with
     its two assertions.

Then three result lines: a JSON object with every kernel's route, source,
launches on the main paths (in all, and by path), error against its plain
version, times, bound and library time; the card's name and power limit as
``nvidia-smi`` gives them; and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# The always-on service at fleet scale (benchmarks/bench_fleet_scale.py:60-77,
# core/compress.py's figure): K workers, grid G, active set M, ring capacity 8.
SVC_K, SVC_G, SVC_M, SVC_RING, SVC_TICKS = 100_000, 512, 2048, 8, 3
RTOL = 2e-5  # the reference kernel tests' _assert_logp_close


def say(*parts) -> None:
    print(*parts, flush=True)


def assert_logp_close(got, want, rtol=RTOL):
    """tests/test_kernels.py's bound, rtol * (1 + max|want|) + rtol * |want|,
    with the scale taken row by row: each (worker, exponent) row is
    normalised over its own grid, so it is held to its own largest
    |logp|, not to the batch's.  Returns max |err| and the largest error
    over its row's scale."""
    import torch

    scale = 1.0 + want.abs().amax(dim=-1, keepdim=True)
    err = (got - want).abs()
    bound = rtol * scale + rtol * want.abs()
    worst = float((err / scale).max())
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"kernel disagrees: max|err| {float(err.max()):.3e}, max|err| over "
                             f"its row's 1 + max|logp| {worst:.3e}, rtol {rtol:g}")
    return float(err.max()), worst


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
        (SVC_M, SVC_G, SVC_RING, False, False),  # the service's active slab (two 256-point passes)
        (SVC_K, SVC_G, SVC_RING, True, False),  # the service's dense drain
    ]
    worst = 0.0
    for i, ((k, g, n, zc, dead), sym) in enumerate(itertools.product(shapes, (True, False))):
        args = fleet_case(k, g, n, seed=i // 2, device="cuda", zero_cols=zc, dead_worker=dead)
        got = posterior_grid_fleet(*args, symmetric_grid=sym)
        want = posterior_grid_plain(*args, symmetric_grid=sym)
        torch.cuda.synchronize()
        err, rel = assert_logp_close(got, want)
        worst = max(worst, err)
        say(f"[k1-parity] {'mirrored' if sym else 'general '} K={k} G={g} N={n} "
            f"zero_cols={zc} dead_worker={dead}: max|err| {err:.3e} (max|logp| "
            f"{float(want.abs().max()):.3e}); max|err| over its row's 1 + max|logp| "
            f"{rel:.3e} within rtol {RTOL:g}")
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
# smollm-135m at full width (phase 7b): batch 4, 512-token prompts, 16 tokens;
# K2 at its decode, (B 4, H 9, KVH 3, D 64, S = prompt + gen + 8 cache rows).
SMOLLM_BATCH, SMOLLM_PROMPT, SMOLLM_GEN = 4, 512, 16
SMOLLM_ARGV = ["--arch", "smollm-135m", "--full", "--batch", str(SMOLLM_BATCH),
               "--prompt-len", str(SMOLLM_PROMPT), "--gen-len", str(SMOLLM_GEN)]
K2_SMOLLM = (SMOLLM_BATCH, 9, 3, 64, SMOLLM_PROMPT + SMOLLM_GEN + 8)


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


def scan_case(b, t, r, seed, dtype, near_one=False):
    """a = sigmoid(N(0, 1)), or with ``near_one`` a in [0.9, 0.9999) as the
    RG-LRU's decays are: there a chunk's product of a stays far above
    float32's rounding, so a carry that drops it shows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    if near_one:
        a = 0.9 + 0.0999 * torch.rand((b, t, r), generator=gen, device="cuda")
    else:
        a = torch.sigmoid(rn(b, t, r))
    return a.to(dtype), rn(b, t, r).to(dtype), rn(b, r).to(dtype)


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
    s = K2_SMOLLM[-1]  # phase 7b's decode: lengths from the first step to the last, and S
    cases.append((K2_SMOLLM, bf16, f32, [SMOLLM_PROMPT + 1, SMOLLM_PROMPT + SMOLLM_GEN - 1, 520, s],
                  2e-2))
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


def misaligned(x):
    """A copy of ``x`` that starts one element past a 16-byte boundary:
    K3 cannot take its rows by TMA and stages them by plain loads."""
    import torch

    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view_as(x)
    return y.copy_(x)


def phase_k3_parity():
    """K3 against its plain version: tests/test_kernels.py's shapes in both
    types, the continuation case, ragged edges of the tiling (one step, a
    chunk less or more one step, a channel tile cut short, a last chunk of
    one step) and the serving path's prefill shape, the last two also with
    decays near 1, where every chunk's carry matters, and the path's shape
    once more from rows that are not 16-byte aligned (plain loads, not TMA);
    then, at the path's
    shape, two calls on the same inputs bitwise equal, and replays of a
    CUDA graph of one call equal to the eager call (the workspace is reset
    on the stream, not by the host)."""
    import torch
    from repro_torch.kernels.lru_scan import CHUNK, lru_scan, lru_scan_plain

    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 1e-5, bf16: 4e-2}
    worst = 0.0
    cases = [((b, t, r), dt, False) for (b, t, r) in [(2, 64, 128), (1, 100, 300), (3, 17, 64)]
             for dt in (f32, bf16)]
    for dt in (f32, bf16):
        cases += [((1, 1, 2560), dt, False), ((2, CHUNK - 1, 300), dt, False),
                  ((2, CHUNK + 1, 2560), dt, False), ((4, 4097, 2560), dt, False),
                  ((4, 4097, 2560), dt, True)]
    cases += [(K3_PATH, f32, False), (K3_PATH, f32, True)]
    cases += [(K3_PATH, f32, "misaligned")]
    for i, (shape, dt, near_one) in enumerate(cases):
        a, x, h0 = scan_case(*shape, seed=200 + i, dtype=dt, near_one=bool(near_one))
        if near_one == "misaligned":
            a, x = misaligned(a), misaligned(x)
        got = lru_scan(a, x, h0)
        want = lru_scan_plain(a, x, h0)
        torch.cuda.synchronize()
        err = assert_close(got, want, tol[dt], tol[dt])
        worst = max(worst, err)
        decays = "a in [0.9, 0.9999)" if near_one else "a = sigmoid(N(0, 1))"
        if near_one == "misaligned":
            decays += ", rows not 16-byte aligned"
        say(f"[k3-parity] (B, T, R)={shape} {dt} {decays}: max|err| {err:.3e} "
            f"within {tol[dt]:g}")
    # continuation: [0:k] then [k:] from the carried state equals one pass
    a, x, _ = scan_case(2, 48, 64, seed=300, dtype=f32)
    h0 = torch.zeros((2, 64), device="cuda")
    full = lru_scan(a, x, h0)
    first = lru_scan(a[:, :20], x[:, :20], h0)
    second = lru_scan(a[:, 20:], x[:, 20:], first[:, -1])
    err = assert_close(second, full[:, 20:], 1e-5, 1e-5)
    worst = max(worst, err)
    say(f"[k3-parity] continuation (2, 48, 64) split at 20: max|err| {err:.3e} within 1e-05")
    # the chained carry rounds alike on every call, eager or replayed
    a, x, h0 = scan_case(*K3_PATH, seed=301, dtype=f32, near_one=True)
    once, again = lru_scan(a, x, h0), lru_scan(a, x, h0)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lru_scan(a, x, h0)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        replayed = lru_scan(a, x, h0)
    for replay in range(3):
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(replayed, once):
            raise AssertionError(f"K3: graph replay {replay} differs from the eager call by "
                                 f"{float((replayed - once).abs().max()):.3e}")
    if not torch.equal(once, again):
        raise AssertionError(f"K3: two calls differ by {float((once - again).abs().max()):.3e}")
    say(f"[k3-parity] (B, T, R)={K3_PATH} float32 a in [0.9, 0.9999): two calls bitwise "
        f"equal, 3 graph replays bitwise equal to the eager call")
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
    """K3 at the serving path's prefill shape, and on a line of its own the
    stream yardstick: ``torch.add(a, x, out=h)`` on the same tensors, which
    moves the same bytes (two reads, one write) with no recurrence."""
    from repro_torch.kernels.lru_scan import lru_scan, lru_scan_plain
    import torch

    b, t, r = K3_PATH
    a, x, h0 = scan_case(*K3_PATH, seed=7, dtype=torch.float32)
    ms = time_cuda(lambda: lru_scan(a, x, h0), runs=20)
    plain_ms = time_cuda(lambda: lru_scan_plain(a, x, h0), runs=5, reps=3)
    a_off, x_off = misaligned(a), misaligned(x)
    plain_loads_ms = time_cuda(lambda: lru_scan(a_off, x_off, h0), runs=20)
    h = torch.empty_like(a)
    stream_ms = time_cuda(lambda: torch.add(a, x, out=h), runs=20)
    ops = 2.0 * b * t * r  # one multiply-add per element
    nbytes = 4.0 * (3 * b * t * r + b * r)  # a, b read, h written, h0 read
    bound_ms, bound_by = bound(ops, nbytes, PEAK_F32_FLOPS)
    say(f"[k3-stream] (B, T, R)={K3_PATH} float32: torch.add(a, x, out=h) {stream_ms:.4f} ms, "
        f"{100 * bound_ms / stream_ms:.1f} % of the bound {bound_ms:.4f} ms (the same bytes, "
        f"no recurrence; a yardstick of streaming, not a library call for K3)")
    say(f"[k3-time] (B, T, R)={K3_PATH}: kernel {ms:.4f} ms ({100 * bound_ms / ms:.1f} % of the "
        f"bound), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, "
        f"{nbytes:.3e} bytes); no single library call computes a linear recurrence")
    say(f"[k3-staging] (B, T, R)={K3_PATH} float32: TMA bulk copies {ms:.4f} ms, plain loads "
        f"(rows not 16-byte aligned) {plain_loads_ms:.4f} ms")
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
    import torch
    from repro_torch import kernels, sched
    from repro_torch.core.frontier import UnitParams
    from repro_torch.device import no_sync

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
            with no_sync(device):
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

def leaves(tree):
    """The tensors of a nested NamedTuple state, in order."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for part in tree for x in leaves(part)]


def assert_bitwise(what, got, want):
    import torch

    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: leaf {i} differs (max|d| "
                                 f"{float((g.float() - w.float()).abs().max()):.3e})")


def service_config(k, *, active=None, async_propose=True, opt_steps=200, num_points=512):
    """The fleet-scale service: n_iters 20, G 512, ring 8, every data tick
    proposes (the gate never fires, staleness always does), the proposal
    floor at the one-in-8K share of phase 6, the prior centred on the truth's
    mean speed (as benchmarks/bench_fleet_scale.py)."""
    from repro_torch import sched, serve

    return serve.ServeConfig(
        sched=sched.SchedulerConfig(n_iters=SWEEPS, grid_size=SVC_G, num_points=num_points,
                                    opt_steps=opt_steps, mu_guess=1.25, min_fraction=1.0 / (8 * k)),
        capacity=SVC_RING, drift_threshold=1e9, max_staleness=1,
        active_size=active, async_propose=async_propose,
    )


def service_truth(k, device, seed):
    """mu = linspace(0.5, 2.0, K), fracs proportional to 1/mu, and a draw of
    t = f^0.9 mu + f^0.8 0.05 mu N(0, 1) per call, on the device."""
    import torch

    mu = torch.linspace(0.5, 2.0, k, device=device)
    fracs = (1.0 / mu) / torch.sum(1.0 / mu)
    gen = torch.Generator(device=device).manual_seed(seed)
    times = lambda: (fracs**0.9 * mu
                     + fracs**0.8 * 0.05 * mu * torch.randn((k,), generator=gen, device=device))
    return fracs, times


def check_active_parity(device, k):
    """(a), (b): the active path at arange(K) is the dense path bit for bit,
    and the slab launch leaves rows outside its index untouched."""
    import torch
    from repro_torch import sched
    from repro_torch.core import gibbs
    from repro_torch.core.moments import BetaParams
    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(3)
    mu = torch.linspace(0.5, 2.0, k, device=device)[:, None]
    f = 0.05 + 0.9 * torch.rand((k, SVC_RING), generator=gen, device=device)
    t = f**0.9 * mu + f**0.8 * 0.05 * mu * torch.randn((k, SVC_RING), generator=gen, device=device)
    state = gibbs.init_state(gen, mu_guess=1.25, shape=(k,))
    config = sched.SchedulerConfig(n_iters=SWEEPS, grid_size=SVC_G)
    every = torch.arange(k, device=device)
    paths = {
        "gibbs_batch": lambda g, idx: gibbs.gibbs_batch(
            state, t, f, generator=g, n_iters=SWEEPS, grid_size=SVC_G, active_idx=idx),
        "advance_fleet": lambda g, idx: sched.advance_fleet(state, t, f, config, g, active_idx=idx),
    }
    for name, run in paths.items():
        seeded = lambda: torch.Generator(device=device).manual_seed(11)
        assert_bitwise(f"{name} active at arange(K)", run(seeded(), every), run(seeded(), None))
        say(f"[service] (a) {name} K={k} G={SVC_G} N={SVC_RING}, {SWEEPS} sweeps: active path at "
            f"arange(K) bitwise the dense path")

    grid, t, f, mask, mu, lam, alpha, beta, aa, ab, ba, bb = fleet_case(
        SVC_K, SVC_G, SVC_RING, seed=9, device=device)
    kw = dict(symmetric_grid=True)
    args = (grid, t, f, mu, lam, alpha, beta, BetaParams(aa, ab), BetaParams(ba, bb), mask)
    dense = ops.posterior_grid_fleet(*args, **kw)
    assert_bitwise("K1 slab at arange(K)", ops.posterior_grid_fleet(
        *args, active_idx=torch.arange(SVC_K, device=device), **kw), dense)
    idx = torch.randperm(SVC_K, generator=gen, device=device)[:SVC_M]
    prev = torch.full_like(dense, 7.0)
    part = ops.posterior_grid_fleet(*args, active_idx=idx, out_prev=prev, **kw)
    outside = torch.ones(SVC_K, dtype=torch.bool, device=device).index_fill(0, idx, False)
    assert_bitwise("K1 slab rows", part.index_select(0, idx), dense.index_select(0, idx))
    if not bool((part[outside] == 7.0).all()):
        raise AssertionError("K1 slab launch wrote rows outside active_idx")
    say(f"[service] (b) K1 slab K={SVC_K} G={SVC_G} N={SVC_RING}: arange(K) bitwise the dense "
        f"launch; M={SVC_M} random rows bitwise the dense rows, the other {SVC_K - SVC_M} "
        f"untouched")


def check_select_active(device):
    """(c): select_active on the device against a stable descending sort on
    the host, with ties, dead slots, fewer live slots than M, and the
    saturated ages of start-up."""
    import numpy as np
    import torch
    from repro_torch.core import compress

    gen = torch.Generator(device=device).manual_seed(4)
    u = lambda: torch.rand((SVC_K,), generator=gen, device=device)
    age = torch.randint(0, 4, (SVC_K,), generator=gen, device=device, dtype=torch.int32)
    nu = torch.where(u() < 0.5, 1.0, 200.0)
    cases = {
        "ties, 10 % dead": dict(age=age, nu=nu, live=(u() > 0.1).float()),
        f"ties, {SVC_M // 2} live": dict(age=age, live=(torch.arange(SVC_K, device=device)
                                                        % (2 * SVC_K // SVC_M) == 0).float()),
        "start-up (all ages saturated)": dict(age=torch.full((SVC_K,), 1_000_000, device=device,
                                                             dtype=torch.int32)),
    }
    for name, kw in cases.items():
        idx, pri = compress.select_active(SVC_M, **kw)
        want = np.argsort(-pri.cpu().numpy(), kind="stable")[:SVC_M]
        if not np.array_equal(idx.cpu().numpy(), want):
            raise AssertionError(f"select_active ({name}) differs from a stable sort")
        say(f"[service] (c) select_active K={SVC_K} M={SVC_M} {name}: the indices of a stable "
            f"descending sort on the host")


def check_round_robin(device, k=8192, m=512):
    """(d): every worker has had a full refresh within ceil(K/M) data ticks."""
    import torch
    from repro_torch import serve
    from repro_torch.device import no_sync

    loop = serve.ServiceLoop(k, config=service_config(k, active=m, async_propose=False,
                                                      opt_steps=10, num_points=64),
                             seed=2, device=device)
    fracs, times = service_truth(k, device, seed=5)
    seen = torch.zeros(k, dtype=torch.bool, device=device)
    ticks = -(-k // m)
    for _ in range(ticks):
        for _ in range(SVC_RING):
            loop.push(fracs, times())
        loop.tick()
        seen |= loop.state.refresh_age == 0
    if not bool(seen.all()):
        raise AssertionError(f"{int((~seen).sum())} workers not refreshed in {ticks} ticks")
    say(f"[service] (d) K={k} M={m}: every worker refreshed within {ticks} data ticks "
        f"(sync propose published version {loop.version})")

    # The branches (e) leaves out, under sync-debug "error" too: hierarchical
    # pooling (surprise in the selection, the hyperprior refit and shrink
    # every 2 drains) and the calibrated gate.
    config = service_config(k, active=m, opt_steps=10, num_points=64)
    config = dataclasses.replace(
        config, sched=dataclasses.replace(config.sched, hierarchical=True, hyper_refit_every=2),
        drift_threshold=None, max_staleness=3)
    loop = serve.ServiceLoop(k, config=config, seed=3, device=device)
    for _ in range(6):
        for _ in range(SVC_RING):
            loop.push(fracs, times())
        loop.tick(no_sync(device))
    loop.poll()
    if not (float(loop.state.hyper.n_workers) == k and int(loop.state.gate.count) >= 1
            and loop.version >= 1 and abs(float(loop.fractions().sum()) - 1.0) < 1e-4):
        raise AssertionError(f"hierarchical service: {loop.counters()}, gate count "
                             f"{int(loop.state.gate.count)}, version {loop.version}")
    say(f"[service] (d) K={k} M={m} hierarchical, calibrated gate, async: 6 ticks with no sync "
        f"before the flag read, {loop.counters()['proposes']} proposes, gate count "
        f"{int(loop.state.gate.count)}")


def drive_service(device, active):
    """(e): one ServiceLoop at K = 100 000, async propose, every advance
    under sync-debug "error"; returns its measurements."""
    import numpy as np
    import torch
    from repro_torch import kernels, serve, sched
    from repro_torch.device import no_sync

    torch.cuda.synchronize()
    m = dict(tick_ms=[], dispatch_ms=[], publish_ms=[], memory=[], advance_peak=0, tick_peak=0,
             before=torch.cuda.memory_allocated())
    config = service_config(SVC_K, active=active)
    loop = serve.ServiceLoop(SVC_K, config=config, seed=1, device=device)
    fracs, times = service_truth(SVC_K, device, seed=4)

    @contextlib.contextmanager
    def advance():  # the tick's work before its flag read, with no sync; its peak memory
        with no_sync(device):
            yield
        m["advance_peak"] = max(m["advance_peak"], torch.cuda.max_memory_allocated())

    for _ in range(1 + SVC_TICKS):
        for _ in range(SVC_RING):
            loop.push(fracs, times())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernels.launch_counts()["posterior_grid_fleet"]
        t0 = time.perf_counter()
        info = loop.tick(advance())
        m["tick_ms"].append((time.perf_counter() - t0) * 1e3)
        launched = kernels.launch_counts()["posterior_grid_fleet"] - before
        if not info.proposed or info.drained != SVC_RING or launched != SWEEPS:
            raise AssertionError(f"tick: proposed {info.proposed}, drained {info.drained}, "
                                 f"K1 launched {launched} times, not {SWEEPS}")
        while not loop.poll():
            time.sleep(1e-4)
        published = time.perf_counter()
        m["tick_peak"] = max(m["tick_peak"], torch.cuda.max_memory_allocated())
        start, end = loop.last_dispatch
        if start < t0:
            raise AssertionError("the tick dispatched no solve")
        m["dispatch_ms"].append((end - start) * 1e3)
        m["publish_ms"].append((published - start) * 1e3)
        fr = loop.fractions()
        if not (np.isfinite(fr).all() and abs(float(fr.sum()) - 1.0) < 1e-4):
            raise AssertionError(f"published split not finite or sums to {float(fr.sum())}")
        torch.cuda.synchronize()
        torch.empty((), device=device)  # frees the blocks that waited on the side stream
        m["memory"].append(torch.cuda.memory_allocated())
    c = loop.counters()
    if c["dropped"] or c["drains"] != 1 + SVC_TICKS or loop.version != 1 + SVC_TICKS:
        raise AssertionError(f"counters {c}, version {loop.version}")
    # Two more solves on the same beliefs, each under its own profiler: CUDA
    # events around it, and the sum of its kernels' device time, whose
    # difference is the time the card waits for the host's launches.
    m["solve_ms"], m["solve_kernel_ms"] = [], []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            start.record()
            serve.solve_published(sched.unit_params(loop.state.sched), config)
            end.record()
            end.synchronize()
        m["solve_ms"].append(start.elapsed_time(end))
        m["solve_kernel_ms"].append(sum(e.device_time_total for e in prof.key_averages()) / 1e3)
    if max(m["memory"][1:]) > m["memory"][0]:
        raise AssertionError(f"device memory grew across ticks: {m['memory']}")
    return m


def check_capacity(device, live_k=4096):
    """(f): a capacity state of 2 x ``live_k`` slots runs admit n -> observe ->
    propose -> retire n -> propose (n = live_k / 8, 512 at 4096) with no sync;
    dead slots get exactly 0 of the proposal and of the quantized
    microbatches."""
    import torch
    from repro_torch import sched
    from repro_torch.device import no_sync

    cap, n = 2 * live_k, live_k // 8
    config = sched.SchedulerConfig(min_fraction=1.0 / (8 * cap))
    state = sched.init(config, live_k, seed=5, device=device, capacity=cap)
    gen = torch.Generator(device=device).manual_seed(6)
    f = 0.05 + 0.9 * torch.rand((cap, SVC_RING), generator=gen, device=device)
    telem = sched.Telemetry(fracs=f, times=f**0.9 * torch.linspace(5.0, 40.0, cap, device=device)[:, None])
    dead = torch.zeros(cap, dtype=torch.bool, device=device)
    dead[torch.randperm(live_k + n, generator=gen, device=device)[:n]] = True
    with no_sync(device):
        state = sched.admit_workers(state, n, config)
        state, _ = sched.observe(state, telem, config)
        admitted_fr, _ = sched.propose(state, config)
        admitted_live = state.live
        state = sched.retire_workers(state, dead)
        fr, stats = sched.propose(state, config)
    live = state.live.cpu().numpy() > 0
    admitted = admitted_live.cpu().numpy() > 0
    total = 8 * int(live.sum())
    counts = sched.quantize_fractions(fr.cpu().numpy(), total, sched.unit_params(state),
                                      objective=config.objective, live=live)
    fr, admitted_fr = fr.cpu().numpy(), admitted_fr.cpu().numpy()
    if not (admitted.sum() == live_k + n and live.sum() == live_k
            and (admitted_fr[~admitted] == 0).all() and (fr[~live] == 0).all()
            and (fr[live] > 0).all() and abs(fr.sum() - 1) < 1e-4
            and (counts[~live] == 0).all() and (counts[live] >= 1).all() and counts.sum() == total):
        raise AssertionError("capacity slots: a dead slot got work, or a live one none")
    say(f"[service] (f) capacity {cap}: admit {n} -> observe -> propose -> retire {n} -> "
        f"propose with no sync; {int((~live).sum())} dead slots get exactly 0 of the proposal and of "
        f"{total} quantized microbatches")


def phase_service(device="cuda"):
    """Slice 5's main path: the always-on estimator service at fleet scale."""
    from repro_torch import kernels
    from repro_torch.core import compress

    check_active_parity(device, k=K_FLEET)
    check_select_active(device)
    check_round_robin(device)

    kernels.reset_launch_counts()
    runs = {mode: drive_service(device, active) for mode, active in (("dense", None),
                                                                      ("active", SVC_M))}
    launches = kernels.launch_counts()
    report = compress.compression_report(SVC_K, SVC_G, SVC_M)
    for mode, m in runs.items():
        timed = m["tick_ms"][1:]
        advance = [t - d for t, d in zip(m["tick_ms"][1:], m["dispatch_ms"][1:])]
        say(f"[service] (e) {mode} K={SVC_K} G={SVC_G} M={SVC_M if mode == 'active' else SVC_K}: "
            f"tick p50 {statistics.median(timed):.1f} ms, max {max(timed):.1f} ms over "
            f"{len(timed)} data ticks (first {m['tick_ms'][0]:.1f} ms), of which the async "
            f"dispatch takes {statistics.median(m['dispatch_ms'][1:]):.1f} ms of host time (p50) "
            f"and the rest, drain to the flag read, p50 {statistics.median(advance):.1f} ms, max "
            f"{max(advance):.1f} ms; dispatch to publish "
            f"{statistics.median(m['publish_ms'][1:]):.1f} ms (p50)")
        mib = lambda x: (x - m["before"]) / 2**20
        solves = ", ".join(
            f"{total:.1f} ms between CUDA events, of which its kernels run {kern:.1f} ms (the card "
            f"idles {100 * (1 - kern / total):.1f} %)"
            for total, kern in zip(m["solve_ms"], m["solve_kernel_ms"]))
        say(f"[service] (e) {mode}: two solves, each under torch.profiler: {solves}; peak "
            f"device memory above the "
            f"{m['before'] / 2**20:.1f} MiB allocated before the loop: "
            f"{mib(m['advance_peak']):.1f} MiB up to the flag read, "
            f"{mib(m['tick_peak']):.1f} MiB with the solve; allocated after each tick "
            f"{[round(mib(x), 1) for x in m['memory']]} MiB (no growth)")
    say(f"[service] compression_report({SVC_K}, {SVC_G}, {SVC_M}): dense "
        f"{report.dense_bytes / 2**20:.1f} MiB, compressed {report.compressed_bytes / 2**20:.1f} "
        f"MiB, ratio {report.ratio:.1f}")

    check_capacity(device)
    say(f"[service] launches on the main path (e): {launches}")
    return launches, runs


# The smoke condition is asserted at the drift gate the reference's own
# --serve-smoke asserts it at, 0.12: at the default 0.05 the reference fails
# it for 15 of the service's seeds 1-24 and the port for 13, alike by
# Fisher's exact test and in their converged drifts
# (tests/test_torch_serve.py::
# test_partitioned_serving_gate_at_the_default_threshold_skips_as_the_reference).
PART_ARGV = ["--arch", "recurrentgemma-2b", "--full", "--rounds", "16", "--replicas", "4",
             "--batch", "16", "--prompt-len", "1024", "--gen-len", "16", "--drain-every", "4",
             "--drift-threshold", "0.12"]


def part_arg(name: str) -> int:
    return int(PART_ARGV[PART_ARGV.index(name) + 1])


def phase_partitioned():
    """Partitioned serving at full width: ``python -m repro_torch.launch.serve``
    with PART_ARGV, in this process so that its launches are counted."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.launch import serve as launch_serve

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = launch_serve.main(PART_ARGV)
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    c = result["counters"]
    if not (c["proposes"] >= 1 and c["drains"] > c["proposes"]):  # launch/serve.py:150-155
        raise AssertionError(f"serve-smoke condition fails: {c}")
    for fr in result["published"]:
        if not (np.isfinite(fr).all() and abs(float(fr.sum()) - 1.0) < 1e-5):
            raise AssertionError(f"a published split is not finite or sums to {fr.sum()}")
    say(f"[partitioned] {' '.join(PART_ARGV)}: {seconds:.1f} s, {c}; {len(result['published'])} "
        f"published splits finite and summing to 1")
    say(f"[partitioned] oracle makespan: equal split {result['oracle_equal']:.4f} s, learned "
        f"split {result['oracle_learned']:.4f} s ({np.round(result['fractions'], 4).tolist()})")
    say(f"[partitioned] launches on the main path: {launches}")
    return launches, result


def phase_partitioned_parity(result, cfg):
    """Each kernel against its plain version at the shapes phase 10 gave it:
    K1 at (replicas, the service's grid, the ring's capacity) in both modes;
    for every batch replica 0 served, K3 at (batch, prompt, d_model) in
    float32, with decays near 1 and from a sigmoid, and K2 at (batch, heads,
    kv heads, head dim, cache rows) with a bfloat16 query and a float32
    cache, at the lengths of the first and the last decode step and those
    between.  Returns each kernel's max |err|."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
    from repro_torch.kernels.lru_scan import lru_scan, lru_scan_plain
    from repro_torch.kernels.posterior_grid import posterior_grid_fleet, posterior_grid_plain

    errs = dict(posterior_grid_fleet=0.0, decode_attention=0.0, lru_scan=0.0)
    config = result["config"]
    k, g, n = part_arg("--replicas"), config.sched.grid_size, config.capacity
    for sym in (True, False):
        args = fleet_case(k, g, n, seed=400, device="cuda")
        want = posterior_grid_plain(*args, symmetric_grid=sym)
        err, rel = assert_logp_close(posterior_grid_fleet(*args, symmetric_grid=sym), want)
        errs["posterior_grid_fleet"] = max(errs["posterior_grid_fleet"], err)
        say(f"[part-parity] K1 {'mirrored' if sym else 'general '} K={k} G={g} N={n}: max|err| "
            f"{err:.3e}; over its row's 1 + max|logp| {rel:.3e} within rtol {RTOL:g}")
    prompt, gen = part_arg("--prompt-len"), part_arg("--gen-len")
    rows = min(cfg.local_window, prompt + gen + 8)  # launch/serve.py's cache, models/layers.py
    first, last = min(prompt + 1, rows), min(prompt + gen - 1, rows)  # valid rows, decode steps
    shape = lambda b: (b, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, rows)
    batches = sorted({int(c[0]) for c in result["counts"]})
    for i, b in enumerate(batches):
        for near_one, tol in ((True, 1e-5), (False, 1e-5)):
            a, x, h0 = scan_case(b, prompt, cfg.d_model, seed=410 + i, dtype=torch.float32,
                                 near_one=near_one)
            err = assert_close(lru_scan(a, x, h0), lru_scan_plain(a, x, h0), tol, tol)
            errs["lru_scan"] = max(errs["lru_scan"], err)
            say(f"[part-parity] K3 (B, T, R)=({b}, {prompt}, {cfg.d_model}) float32 "
                f"{'a in [0.9, 0.9999)' if near_one else 'a = sigmoid(N(0, 1))'}: max|err| "
                f"{err:.3e} within {tol:g}")
        lengths = [first, last] + [first + j % (last - first + 1) for j in range(b - 2)]
        args = decode_case(*shape(b), seed=420 + i, q_dtype=torch.bfloat16,
                           kv_dtype=torch.float32, length=lengths[:b])
        err = assert_close(decode_attention(*args), decode_attention_plain(*args), 2e-2, 2e-2)
        errs["decode_attention"] = max(errs["decode_attention"], err)
        say(f"[part-parity] K2 (B, H, KVH, D, S)={shape(b)} q bfloat16 cache float32 lengths "
            f"{args[3].tolist()}: max|err| {err:.3e} within 2e-02")
    torch.cuda.synchronize()
    return errs


def phase_serve_smollm():
    """Phase 7b: smollm-135m at full width through the serving CLI's entry
    point; K2 at (G, D) = (3, 64) once per layer of every decode step."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx

    launch_serve.main(SMOLLM_ARGV + ["--gen-len", "2"])  # set-up at the same shapes
    kernels.reset_launch_counts()
    out = launch_serve.main(SMOLLM_ARGV)
    launches = kernels.launch_counts()
    cfg, tokens = out["cfg"], out["tokens"]
    logits, _ = model_zoo.decode_step(cfg, out["params"], tokens[:, -1:], out["cache"],
                                      ctx=ApplyCtx(mode="decode"))
    if logits.shape != (SMOLLM_BATCH, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or misshapen")
    if tokens.shape != (SMOLLM_BATCH, SMOLLM_GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generated tokens {tuple(tokens.shape)} out of shape or range")
    want = cfg.num_layers * (SMOLLM_GEN - 1)
    if launches.get("decode_attention") != want:
        raise AssertionError(f"K2 launched {launches} times serving smollm-135m, not {want}")
    say(f"[smollm] {' '.join(SMOLLM_ARGV)}: {cfg.num_layers} layers, (G, D) = "
        f"({cfg.num_heads // cfg.num_kv_heads}, {cfg.resolved_head_dim}); prefill "
        f"{out['prefill_ms']:.1f} ms, decode {out['decode_ms']:.2f} ms/token, logits finite")
    say(f"[smollm] launches on the main path: {launches}")
    return launches


# Phase 11: the workflow DAG (slice 6).  S = 8 stages, K = 512 workers each
# (stage 7 256 wide), N = 256 observations per worker per batch.
DAG_K, DAG_N, DAG_MC = 512, 256, 200_000
DAG_EDGES = ((0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4), (4, 5), (4, 6), (5, 7), (6, 7))
DAG_SCALE = (0.4, 1.6, 1.0, 0.5, 0.4, 0.8, 1.2, 0.6)
DAG_TOL = dict(mean=1.5e-2, var=8e-2)  # the reference's in-tree tolerances, printed beside


def dag_topology(k):
    """(deterministic, stochastic) topologies of phase 11 at width ``k``."""
    from repro_torch import sched

    det = sched.WorkflowDAG.from_edges(8, DAG_EDGES, num_workers=k).with_stage_workers(
        (k,) * 7 + (k // 2,))
    sto = det.with_stochastic(
        exec_probs=(1.0, 1.0, 0.3, 1.0, 1.0, 1.0, 0.5, 1.0),
        rework_probs=(0.0, 0.0, 0.0, 0.4, 0.0, 0.2, 0.0, 0.0),
        max_retries=(1, 1, 1, 4, 1, 3, 1, 1),
    )
    return det, sto


def dag_truth(k, device, seed=2016):
    """Per stage, workers k < K/2 fast and noisy (mu 5, sigma 6), the rest
    slow and precise (mu 9, sigma 0.3), as benchmarks/bench_dag.py's
    diamond; each mu jittered by e^U[-0.2, 0.2], stages scaled by
    DAG_SCALE; alpha 0.9, beta 0.55.  From a numpy seed."""
    import numpy as np
    import torch
    from repro_torch.core.frontier import UnitParams

    rng = np.random.default_rng(seed)
    fast = np.arange(k) < k // 2
    scale = np.asarray(DAG_SCALE)[:, None]
    mu = scale * np.where(fast, 5.0, 9.0)[None, :] * np.exp(rng.uniform(-0.2, 0.2, (8, k)))
    sigma = scale * np.where(fast, 6.0, 0.3)[None, :] * np.ones((8, 1))
    leaves = (mu, sigma, np.full((8, k), 0.9), np.full((8, k), 0.55))
    return UnitParams(*(torch.as_tensor(x, dtype=torch.float32, device=device) for x in leaves))


def check_dag_k1_parity(device, k=DAG_K, n=DAG_N):
    """K1 at the folded block that each of observe_dag's sweeps launches,
    (8 x k, GRID, n), through the stacked (S, K, N) entry, in both modes."""
    import torch
    from repro_torch.core.moments import BetaParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.posterior_grid import posterior_grid_plain

    worst = 0.0
    stack = lambda x: x.reshape(8, k, *x.shape[1:])
    for sym in (True, False):
        args = fleet_case(8 * k, GRID, n, seed=500, device=device, zero_cols=not sym)
        grid, t, f, mask, mu, lam, alpha, beta, aa, ab, ba, bb = args
        got = ops.posterior_grid_fleet(
            grid, stack(t), stack(f), stack(mu), stack(lam), stack(alpha), stack(beta),
            BetaParams(stack(aa), stack(ab)), BetaParams(stack(ba), stack(bb)), stack(mask),
            symmetric_grid=sym)
        want = posterior_grid_plain(*args, symmetric_grid=sym)
        if device != "cpu":
            torch.cuda.synchronize()
        err, rel = assert_logp_close(got.reshape(8 * k, 2, GRID), want)
        worst = max(worst, err)
        say(f"[dag] K1 {'mirrored' if sym else 'general '} through the stacked entry at (S, K, N) = "
            f"(8, {k}, {n}), G={GRID}: max|err| {err:.3e}; over its row's 1 + max|logp| {rel:.3e} "
            f"within rtol {RTOL:g}")
    return worst


def phase_dag(device="cuda", k=DAG_K, n=DAG_N, mc=DAG_MC, diamond_mc=200_000):
    """Slice 6's main path: observe_dag -> propose_dag -> quantize_dag_fractions
    on the 8-stage stochastic DAG, then its quality on the simulator.

    ``device="cpu"`` with a small ``k``, ``n`` and ``mc`` rehearses it
    without a card (no sync check, no device clocks)."""
    import numpy as np
    import torch
    import pipeline_dag_torch
    from repro_torch import kernels, sched, sim
    from repro_torch.device import no_sync

    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def clock(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    k1_err = check_dag_k1_parity(device, k, n)
    det, sto = dag_topology(k)
    truth = dag_truth(k, device)
    live = sto.stage_live(device)
    live_np = live.cpu().numpy() > 0
    uniform = sched.uniform_fractions(sto, device)
    budget = 0.5 * float(sched.dag_stats(sto, uniform, truth, num_points=512).var)
    # The proposal floor at one microbatch in 8K, as phase 9: the default
    # 5e-3 x 512 > 1 would force the uniform split.
    config = sched.SchedulerConfig(objective=sched.Objective.variance_budget(budget),
                                   n_iters=SWEEPS, grid_size=GRID, num_points=512,
                                   opt_steps=200, min_fraction=1.0 / (8 * k))
    # Each stage is rounded to 8K microbatches by largest remainder, without
    # the objective's move refinement: an end-to-end variance budget gives
    # no per-stage objective to refine against, and refining each stage on
    # E[t] walked 512 moves a stage away from the budgeted split, at ~37 ms
    # a move on an H100 (PERF.md).  The refinement runs once below.
    total = 8 * k
    gen = torch.Generator(device=device).manual_seed(2017)

    def telemetry(fracs):
        # n jobs per worker, sizes e^[-2, 2] around its share (dead columns
        # work a benign 1/K share; observe_dag masks them)
        share = torch.where(live > 0, fracs, 1.0 / k)[..., None]
        f = share * torch.exp(-2.0 + 4.0 * torch.rand((8, k, n), generator=gen, device=device))
        eps = torch.randn((8, k, n), generator=gen, device=device)
        t = f ** truth.alpha[..., None] * truth.mu[..., None] + \
            f ** truth.beta[..., None] * truth.sigma[..., None] * eps
        return sched.Telemetry(fracs=f, times=t)

    state = sched.init_dag(config, sto, seed=0, device=device)
    fracs = uniform
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for c in range(CYCLES):
        telem = telemetry(fracs)

        def observe_and_propose():
            with no_sync(device):
                st, ll = sched.observe_dag(state, telem, config, dag=sto)
                fr, stats = sched.propose_dag(st, sto, config)
            return st, ll, fr, stats

        (state, ll, fracs, stats), ms_cycle = clock(observe_and_propose)
        counts, ms_quant = clock(lambda: sched.quantize_dag_fractions(
            fracs.cpu().numpy(), total, live=live_np))
        fr = fracs.cpu().numpy()
        if not bool(torch.isfinite(ll[live > 0]).all()):
            raise AssertionError("non-finite log-likelihood on a live worker")
        if not (np.isfinite(fr).all() and np.abs(fr.sum(-1) - 1.0).max() < 1e-4
                and (fr[~live_np] == 0).all() and (fr[live_np] > 0).all()):
            raise AssertionError(f"stage splits not finite, not on the simplex, or dead columns "
                                 f"not 0: row sums {fr.sum(-1)}")
        if not ((counts.sum(-1) == total).all() and (counts[~live_np] == 0).all()
                and (counts[live_np] >= 1).all()):
            raise AssertionError(f"counts {counts.sum(-1)} per stage, not {total}, or a dead "
                                 f"column got work")
        say(f"[dag] cycle {c}: observe_dag + propose_dag {ms_cycle:.1f} ms (sync-free), "
            f"quantize_dag_fractions {ms_quant:.1f} ms, E[t] {float(stats.e_t):.5f} "
            f"Var {float(stats.var):.6f} (budget {budget:.6f})")
    launches = kernels.launch_counts()

    # Each step on its own, on the final beliefs (after the launch count).
    def guarded(fn):
        with no_sync(device):
            return fn()

    telem = telemetry(fracs)
    _, ms_observe = clock(lambda: guarded(lambda: sched.observe_dag(state, telem, config, dag=sto)))
    (f_det, _), ms_det = clock(lambda: guarded(lambda: sched.propose_dag(state, det, config)))
    (f_sto, _), ms_sto = clock(lambda: guarded(lambda: sched.propose_dag(state, sto, config)))
    rounded, ms_quant = clock(lambda: sched.quantize_dag_fractions(
        f_sto.cpu().numpy(), total, live=live_np))
    # The move refinement (quantize_fractions(params=)) at this width, once,
    # as a yardstick: one pass, at most 128 moves a stage, one device read a
    # move; each stage refines its own E[t] under the truth.
    refined, ms_refine = clock(lambda: sched.quantize_dag_fractions(
        f_sto.cpu().numpy(), total, truth, refine_passes=1, live=live_np))
    if not ((refined.sum(-1) == total).all() and (refined[~live_np] == 0).all()
            and (refined[live_np] >= 1).all()):
        raise AssertionError(f"refined counts {refined.sum(-1)} per stage, not {total}, or a "
                             f"dead column got work")
    moves = int(np.abs(refined - rounded).sum()) // 2  # each move shifts one microbatch
    # Quality at the true parameters: one sampled world for every split.
    price = lambda f: sim.simulate_workflow(7, sto, f, truth, num_samples=mc, device=device)
    t_sto, ms_sim = clock(lambda: price(f_sto))
    t_det, t_uni = price(f_det), price(uniform)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    e_sto, e_det, e_uni = float(t_sto.mean()), float(t_det.mean()), float(t_uni.mean())
    d_uni, d_det = t_uni - t_sto, t_det - t_sto
    se = lambda d: float(d.std()) / len(d) ** 0.5
    if not e_sto < e_uni:
        raise AssertionError(f"learned split E[t] {e_sto:.5f} not below the uniform split's {e_uni:.5f}")
    # Where the deterministic-assumption split goes: the workers believed at
    # mu <= 0 (a stage solve ranks them fastest), and the same split made
    # from the truth instead of the beliefs (params=).
    beliefs = sched.stage_params(state)
    negative = ((beliefs.mu <= 0) & (live > 0)).to(f_det.dtype)
    f_det_truth, _ = sched.propose_dag(state, det, config, params=truth)
    e_det_truth = float(price(f_det_truth).mean())
    analytic = sched.dag_stats(sto, f_sto, truth, num_points=config.num_points)
    a_e, a_v, s_v = float(analytic.e_t), float(analytic.var), float(t_sto.var(correction=0))
    say(f"[dag] S=8 K={k} N={n} (S K = {8 * k}): observe_dag {ms_observe:.1f} ms, propose_dag "
        f"deterministic {ms_det:.1f} ms, stochastic {ms_sto:.1f} ms (joint refinement included), "
        f"quantize_dag_fractions {ms_quant:.1f} ms, simulate_workflow ({len(t_sto)} samples) "
        f"{ms_sim:.1f} ms, peak device memory {peak / 2**20:.1f} MiB")
    say(f"[dag] quantize_dag_fractions with the move refinement (params=, one pass): "
        f"{ms_refine:.1f} ms for at least {moves} moves over 8 stages"
        f"{f', {ms_refine / moves:.2f} ms a move at most' if moves else ''}")
    say(f"[dag] E[t] on the simulator under the truth (common random numbers, {len(t_sto)} "
        f"samples): learned {e_sto:.5f}, uniform {e_uni:.5f} (uniform - learned {float(d_uni.mean()):.5f}"
        f" +- {se(d_uni):.5f} s.e.), deterministic-assumption {e_det:.5f} (minus the "
        f"stochastic-aware split: {float(d_det.mean()):+.5f} +- {se(d_det):.5f} s.e.)")
    say(f"[dag] {int(negative.sum())} live workers believed at mu <= 0 take "
        f"{float((f_det * negative).sum(-1).mean()):.4f} of a stage's work in the "
        f"deterministic-assumption split, {float((f_sto * negative).sum(-1).mean()):.4f} in the "
        f"stochastic-aware one; the deterministic-assumption split made from the truth "
        f"(params=): E[t] {e_det_truth:.5f} on the simulator")
    fast = (torch.arange(k, device=device) < k // 2).to(f_det.dtype)
    stage_e = lambda f: sched.dag_stats(sto, f, truth, num_points=config.num_points).stage_e
    row = lambda x: "[" + " ".join(f"{float(v):.3f}" for v in x) + "]"
    for name, f in (("uniform", uniform), ("deterministic-assumption", f_det),
                    ("stochastic-aware", f_sto), ("deterministic from the truth", f_det_truth)):
        say(f"[dag] {name} split, stage by stage: E under the truth {row(stage_e(f))}, share on "
            f"the fast-noisy half {row((f * fast).sum(-1))}")
    ratio = lambda x, y, m: float(torch.median((x / y)[(m > 0) & (live > 0)]))
    say(f"[dag] beliefs over the truth (median over live workers): mu {ratio(beliefs.mu, truth.mu, fast):.3f}"
        f" fast-noisy, {ratio(beliefs.mu, truth.mu, 1 - fast):.3f} slow-precise; sigma "
        f"{ratio(beliefs.sigma, truth.sigma, fast):.3f} fast-noisy, "
        f"{ratio(beliefs.sigma, truth.sigma, 1 - fast):.3f} slow-precise")
    say(f"[dag] learned split, analytic composition against the simulator: E[t] {a_e:.5f} vs "
        f"{e_sto:.5f} ({100 * (a_e / e_sto - 1):+.2f} %, the reference's in-tree tolerance "
        f"{100 * DAG_TOL['mean']:.1f} %), Var {a_v:.6f} vs {s_v:.6f} ({100 * (a_v / s_v - 1):+.2f} %, "
        f"tolerance {100 * DAG_TOL['var']:.0f} %; the fan-outs share ancestors, where the PERT max "
        f"is approximate: not asserted)")
    say(f"[dag] launches on the main path: {launches}")

    diamond = pipeline_dag_torch.stochastic_diamond(device, diamond_mc)
    if not (diamond["gap_det"] > 0.0 and diamond["gap_uniform"] > 0.0):
        raise AssertionError(f"examples/pipeline_dag_torch.py's diamond: {diamond}")
    say(f"[dag] examples/pipeline_dag_torch.py's diamond on {device}: the stochastic-aware split "
        f"beats the deterministic-assumption one by {diamond['gap_det']:+.4f} (+- "
        f"{diamond['se_det']:.4f} s.e.) and the uniform one by {diamond['gap_uniform']:+.4f}")
    return launches, k1_err


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
    smollm_launches = phase_serve_smollm()
    service_launches, _ = phase_service()
    drives = 2 * (1 + SVC_TICKS)  # dense and active loops, a warm-up tick and the timed ones
    if service_launches.get("posterior_grid_fleet") != SWEEPS * drives:
        raise AssertionError(f"K1 launched {service_launches} times on the service path, "
                             f"not {SWEEPS * drives}")
    part_launches, result = phase_partitioned()
    counters, rounds, gen_len = result["counters"], part_arg("--rounds"), part_arg("--gen-len")
    want = dict(posterior_grid_fleet=result["config"].sched.n_iters * counters["drains"],
                lru_scan=kinds.count("rglru") * rounds,
                decode_attention=kinds.count("localattn") * (gen_len - 1) * rounds)
    for name, n in want.items():
        if part_launches.get(name) != n:
            raise AssertionError(f"{name} launched {part_launches.get(name)} times in partitioned "
                                 f"serving, not {n}")
    part_cfg = get_arch(PART_ARGV[PART_ARGV.index("--arch") + 1])
    for name, err in phase_partitioned_parity(result, part_cfg).items():
        errs[name] = max(errs[name], err)
    dag_launches, dag_err = phase_dag()
    errs["posterior_grid_fleet"] = max(errs["posterior_grid_fleet"], dag_err)
    if dag_launches.get("posterior_grid_fleet") != SWEEPS * CYCLES:  # 20 per observe_dag
        raise AssertionError(f"K1 launched {dag_launches} times on the DAG path, not {SWEEPS * CYCLES}")
    by_path = dict(fleet=fleet_launches, serve=serve_launches, serve_smollm=smollm_launches,
                   service=service_launches, partitioned=part_launches, dag=dag_launches)
    kernels = [
        ("posterior_grid_fleet", "posterior_grid.cu", "src/repro/kernels/posterior_grid.py:108"),
        ("decode_attention", "decode_attention.cu", "src/repro/kernels/decode_attention.py:81"),
        ("lru_scan", "lru_scan.cu", "src/repro/kernels/lru_scan.py:52"),
    ]
    path_launches = lambda name: {p: c.get(name, 0) for p, c in by_path.items() if c.get(name)}
    say(json.dumps({"kernels": [dict(
        name=name,
        route="cuda",
        source=f"src/repro_torch/kernels/csrc/{source}",
        replaces=replaces,
        launches=sum(path_launches(name).values()),
        launches_by_path=path_launches(name),
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
