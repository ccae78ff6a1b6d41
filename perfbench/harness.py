"""The benchmark harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name:

  * ``configs/<config>.json``: the configuration as it is run;
  * ``mixes/<traffic>.json``: the traffic's parameters, naming the driver
    (``drivers/<driver>.py``) that generates and serves it;
  * ``metrics/<metric>.py``: a reader, ``read(record) -> float | None``;
  * ``limits/<workload>.json``: the limit of each number the cell's check
    compares (``checks`` of the driver), and the readings it was set from.

A driver's ``run(record, cfg, mix, seed, device)`` makes its inputs from
the seed, warms up, measures inside ``record.window()`` and returns its
samples; ``check(samples, cfg, mix, seed, control=False)`` then compares
them with the plain reference (``reference/``) and returns the numbers.
The program under test is ``repro_torch``; nothing here imports the JAX
package.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def log(msg: str) -> None:
    """A progress line on standard error."""
    print(f"[perfbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_file_module(path: Path):
    """A module from a file whose name may hold dots (``metrics/mfu.serve.py``)."""
    name = "perfbench_file_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Modules loaded whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-quantile (0..1) by linear interpolation between order statistics."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Cell:
    """One workload of the manifest with its configuration, mix and limits."""

    def __init__(self, manifest: dict, workload: str, bench: Path = BENCH):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the manifest has {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.cfg = load_json(bench.parent / self.config_entry["file"])
        self.mix = load_json(bench / "mixes" / f"{self.workload['traffic']}.json")
        limits = bench / "limits" / f"{workload}.json"
        self.limits = load_json(limits)["limits"] if limits.exists() else {}
        self.driver = importlib.import_module(f"perfbench.drivers.{self.mix['driver']}")
        self.bench = bench
        self.end_to_end = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in manifest["per_layer"] if workload in m.get("workloads", [workload])]


class Record:
    """What a run measured: host spans and work counted inside the window,
    counters, kernel launch shapes and, with tracing, the device trace."""

    def __init__(self, seconds: float, trace: bool, device, t_start: float):
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.work: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self.launches: Dict[str, list] = {}
        self.window_span: Optional[Tuple[float, float]] = None
        self.setup_s: Optional[float] = None
        self.gpu: Optional[dict] = None  # the trace's summary (kernels, busy_s, window_s, gaps)
        self.deadline = math.inf
        self.measuring = False

    # -- recording ----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_span(name, t0, time.perf_counter())

    def add_span(self, name: str, t0: float, t1: float) -> None:
        if self.measuring:
            self.spans.setdefault(name, []).append((t0, t1))

    def add_work(self, name: str, n: float) -> None:
        if self.measuring:
            self.work[name] = self.work.get(name, 0) + n

    def add_launch(self, kernel: str, shape: tuple, n: int = 1) -> None:
        if self.measuring:
            self.launches.setdefault(kernel, []).append((tuple(shape), n))

    def expired(self) -> bool:
        return time.perf_counter() >= self.deadline

    @property
    def window_s(self) -> float:
        return self.window_span[1] - self.window_span[0]

    def durations(self, name: str) -> List[float]:
        return [b - a for a, b in self.spans.get(name, [])]

    # -- the measured window ------------------------------------------------
    @contextlib.contextmanager
    def window(self):
        """Set-up ends here; the driver's loop runs inside until ``expired``.
        With tracing, ``torch.profiler`` records the device's work of exactly
        this window."""
        import torch

        sync = (lambda: torch.cuda.synchronize()) if self.device.type == "cuda" else (lambda: None)
        sync()
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CUDA] if self.device.type == "cuda" else [ProfilerActivity.CPU]
            prof = profile(activities=acts)
            prof.__enter__()
        t0 = time.perf_counter()
        self.epoch0 = time.time_ns() - int(t0 * 1e9)
        self.setup_s = t0 - self.t_start
        self.deadline = t0 + self.seconds
        self.measuring = True
        try:
            yield
            sync()
        finally:
            self.measuring = False
            self.window_span = (t0, time.perf_counter())
            if prof is not None:
                prof.__exit__(None, None, None)
        if prof is not None:
            self.gpu = summarize_trace(prof, self)


def summarize_trace(prof, rec: Record) -> dict:
    """Device time by kernel name, the union of device busy intervals, and
    the longest idle gaps named by the innermost host span around them."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if rec.device.type == "cuda" else DeviceType.CPU
    by_name: Dict[str, List[float]] = {}
    intervals = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != want:
            continue
        if want == DeviceType.CPU and not e.name().startswith("aten::"):
            continue
        s, d = e.start_ns(), e.duration_ns()
        entry = by_name.setdefault(e.name(), [0, 0.0])
        entry[0] += 1
        entry[1] += d * 1e-9
        intervals.append((s, s + d))
    intervals.sort()
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    w0 = rec.epoch0 + int(rec.window_span[0] * 1e9)
    w1 = rec.epoch0 + int(rec.window_span[1] * 1e9)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = ((a + b) / 2 - rec.epoch0) * 1e-9
        inner, width = "untracked host work", math.inf
        for name, spans in rec.spans.items():
            for s0, s1 in spans:
                if s0 <= mid <= s1 and s1 - s0 < width:
                    inner, width = name, s1 - s0
        named.append([inner, (b - a) * 1e-9])
    return dict(kernels=by_name, busy_s=busy, window_s=rec.window_s, gaps=named)


def device_info(chips: int) -> dict:
    import torch

    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def read_metrics(cell: Cell, rec: Record, entries: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in entries:
        reader = load_file_module(cell.bench / "metrics" / f"{m['name']}.py")
        value = reader.read(rec, cell.cfg, cell.mix)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Every number within its limit; a number with no limit, or that is not
    finite, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and math.isfinite(value) and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok and bool(numbers), checks


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run: set-up and window (the driver), the memory peak, then the
    check against the reference with the program's state freed."""
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rec = Record(seconds, trace, device, t_start)
    samples = cell.driver.run(rec, cell.cfg, cell.mix, seed, device)
    log(f"window {rec.window_s:.2f} s after {rec.setup_s:.2f} s of set-up; work {rec.work}")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        numbers = cell.driver.check(samples, cell.cfg, cell.mix, seed)
        error = None
    except Exception as exc:  # a check that cannot run is a failed check
        import traceback

        traceback.print_exc()
        numbers, error = {}, f"{type(exc).__name__}: {exc}"
    log("check done")
    correct, checks = judge(numbers, cell.limits)
    metrics = read_metrics(cell, rec, cell.per_layer if trace else cell.end_to_end)
    return dict(correct=correct, attempted=int(rec.work.get("attempted", 0)),
                failed=int(rec.work.get("attempted", 0) - rec.work.get("completed", 0)),
                metrics=metrics, peak=peak, rec=rec, checks=checks, error=error)


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    cell = Cell(load_json(ROOT / "BENCHMARK.json"), args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one process with few threads: steadier host times
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    dev = device_info(cell.chips)
    dev["memory_peak_bytes"] = int(res["peak"])
    line = dict(correct=res["correct"], attempted=res["attempted"], failed=res["failed"],
                metrics=res["metrics"], device=dev)
    rec = res["rec"]
    if args.trace and rec.gpu is not None:
        dev["busy_s"] = rec.gpu["busy_s"]
        dev["window_s"] = rec.gpu["window_s"]
        top = sorted(rec.gpu["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
        line["breakdown"] = {"device_ops": [[n[:160], v[1]] for n, v in top],
                             "idle_gaps": rec.gpu["gaps"]}
    if res["error"]:
        line["check_error"] = res["error"][:500]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
