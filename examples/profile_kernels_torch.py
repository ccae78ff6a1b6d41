#!/usr/bin/env python3
"""Where the serving path's kernels spend their time on the card.

    python3 examples/profile_kernels_torch.py

K1 (the fleet posterior grid at the fleet cycle's shape, K 4096, G 256,
N 256, in its mirrored and general modes), K2 (decode attention,
recurrentgemma-2b's decode shape: B 4, H 10, KVH 1, D 256, S 2048, bf16 q,
float32 cache) and K3 (the linear-recurrence scan, its prefill shape: B 4,
T 4096, R 2560, float32), with K2's plain version and
``scaled_dot_product_attention`` beside it, on the same inputs every
call (so K2's 16.8 MB stay in the 50 MB L2).  For each: the time of one
call as CUDA events see it around a single call (host launch overhead
included), around 20 calls back to back, and around a CUDA graph replay of
20 calls (device time only); K3 in float32 and bfloat16 beside the stream
yardstick ``torch.add(a, x, out=h)``, which moves K3's bytes; then each CUDA kernel's device time by name, from
``torch.profiler``, and each function's sum of them (K3's includes the
memset of its workspace); and last, how many PyTorch operations one decode
step of full-width recurrentgemma-2b dispatches (each costs host time in an
eager decode).  Needs a CUDA card; prints the card's name and power limit
first.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain  # noqa: E402
from repro_torch.kernels.lru_scan import lru_scan, lru_scan_plain  # noqa: E402
from repro_torch.kernels.posterior_grid import posterior_grid_fleet  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models.layers import ApplyCtx  # noqa: E402

REPS = 20


def events(fn, reps: int, runs: int = 15) -> float:
    """Median ms per call between CUDA events around ``reps`` eager calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_replay(fn, reps: int = REPS, runs: int = 15) -> float:
    """Median ms per call of a CUDA graph of ``reps`` calls, replayed."""
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
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


class CountOps(TorchDispatchMode):
    """Counts the PyTorch operations dispatched inside the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def decode_step_ops() -> int:
    """Operations of one decode step of recurrentgemma-2b, batch 4, full width."""
    cfg = get_arch("recurrentgemma-2b")
    params = model_zoo.init_model_params(cfg, seed=0)
    cache = model_zoo.init_cache(cfg, 4, 64, torch.float32)
    tokens = torch.zeros((4, 16), dtype=torch.int32, device="cuda")
    model_zoo.prefill(cfg, params, {"tokens": tokens}, cache, ctx=ApplyCtx(mode="prefill"))
    with CountOps() as count:
        model_zoo.decode_step(cfg, params, tokens[:, -1:], cache, ctx=ApplyCtx(mode="decode"))
    return count.n


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(7)
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    b, h, kvh, d, s = 4, 10, 1, 256, 2048
    q, k, v = rn(b, h, d).bfloat16(), rn(b, s, kvh, d), rn(b, s, kvh, d)
    length = torch.full((b,), s, dtype=torch.int32, device="cuda")
    q4, k4, v4 = q.float()[:, :, None, :], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device="cuda")[None, :] < length[:, None])[:, None, None, :]
    a, x, h0 = torch.sigmoid(rn(4, 4096, 2560)), rn(4, 4096, 2560), rn(4, 2560)
    kf, g, n = 4096, 256, 256
    f = 0.05 + 0.9 * torch.rand((kf, n), generator=gen, device="cuda")
    lin = lambda lo, hi: torch.linspace(lo, hi, kf, device="cuda")
    k1_args = (torch.linspace(1e-4, 1 - 1e-4, g, device="cuda"),
               f**0.9 * lin(5.0, 40.0)[:, None] + f**0.7 * 2.0 * rn(kf, n), f,
               torch.ones((kf, n), device="cuda"), lin(5.0, 40.0), lin(0.1, 0.5),
               lin(0.6, 0.95), lin(0.5, 0.9), lin(1.5, 4.0), lin(2.0, 3.0), lin(2.0, 5.0),
               lin(1.5, 2.5))
    fns = {
        "K1 posterior_grid mirrored": lambda: posterior_grid_fleet(*k1_args, symmetric_grid=True),
        "K1 posterior_grid general": lambda: posterior_grid_fleet(*k1_args),
        "K2 decode_attention": lambda: decode_attention(q, k, v, length),
        "K2 plain version": lambda: decode_attention_plain(q, k, v, length),
        "K2 SDPA": lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True),
        "K3 lru_scan": lambda: lru_scan(a, x, h0),
        "K3 plain version": lambda: lru_scan_plain(a, x, h0),
    }
    for name, fn in fns.items():
        print(f"{name}: per-call events {events(fn, 1):.4f} ms, {REPS} back to back "
              f"{events(fn, REPS):.4f} ms, graph replay {graph_replay(fn):.4f} ms per call",
              flush=True)
    for a_t, x_t in ((a, x), (a.bfloat16(), x.bfloat16())):
        h = torch.empty_like(a_t)
        print(f"K3 {a_t.dtype}: graph replay {graph_replay(lambda: lru_scan(a_t, x_t, h0)):.4f} "
              f"ms per call; stream yardstick torch.add(a, x, out=h) "
              f"{graph_replay(lambda: torch.add(a_t, x_t, out=h)):.4f} ms", flush=True)
    for name in ("K1 posterior_grid mirrored", "K2 decode_attention", "K3 lru_scan"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fns[name]()
            torch.cuda.synchronize()
        total = 0.0
        for evt in prof.key_averages():
            if evt.device_time_total > 0:
                total += evt.device_time_total / REPS
                print(f"{name}: {evt.key[:60]} {evt.count} launches, "
                      f"{evt.device_time_total / evt.count:.2f} us each", flush=True)
        print(f"{name}: {total:.2f} us of device time per call, all entries", flush=True)
    print(f"recurrentgemma-2b decode step (batch 4): {decode_step_ops()} PyTorch operations "
          f"dispatched", flush=True)


if __name__ == "__main__":
    main()
