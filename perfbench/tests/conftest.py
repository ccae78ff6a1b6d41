"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark whose
configurations and mixes are cut to a size the CPU runs in seconds."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402
import torch  # noqa: E402

from perfbench import harness  # noqa: E402

TINY_CONFIGS = {
    "fleet-100k": dict(workers=16, grid_size=16, sweeps=2, num_points=32, opt_steps=5),
    "yi-9b": dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                  num_key_value_heads=1, num_hidden_layers=2, vocab_size=256),
}
TINY_MIXES = {
    "every-drain": dict(warm_cycles=2, check=dict(gibbs_cycles=1, gibbs_from=2, splits=1,
                                                  quantized=1)),
    "gated": dict(warm_cycles=2, check=dict(gibbs_cycles=1, gibbs_from=2, splits=1, quantized=1)),
    "code": dict(prompt_len=16, gen_len=4, requests_per_round=8, setup_rounds=8,
                 check=dict(requests=10**6)),  # every request of the window
}

# The served model's limit at this width: its logits spread 8x less than the
# full width's (hidden 64 against 4096 under the same 0.02 head scale), so the
# full width's limit would pass any fault here.  Over every token of a 1 s
# window on 4 seeds at this width the program read at most 2.6e-3 and the
# control (fp8 weights) at least 1.08e-2.
TINY_LIMITS = {"yi-9b.code": {"token_gap": 6e-3}}


def make_tiny_bench(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``perfbench/`` under ``dest``, cut small."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    bench = dest / "perfbench"
    for kind, table in (("configs", TINY_CONFIGS), ("mixes", TINY_MIXES)):
        for name, change in table.items():
            path = bench / kind / f"{name}.json"
            data = harness.load_json(path)
            data.update(change)
            path.write_text(json.dumps(data))
    for name, limits in TINY_LIMITS.items():
        (bench / "limits" / f"{name}.json").write_text(json.dumps({"limits": limits}))
    return bench


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return make_tiny_bench(tmp_path_factory.mktemp("tiny"))


def run_tiny(bench: Path, workload: str, *, seed: int = 2**31 + 12345, seconds: float = 1.0,
             trace: bool = False) -> dict:
    """One run of a cut cell on the CPU, past the harness's look for a card."""
    torch.set_num_threads(1)
    cell = harness.Cell(harness.load_json(bench.parent / "BENCHMARK.json"), workload, bench=bench)
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())


def tiny_cell(bench: Path, workload: str) -> "harness.Cell":
    return harness.Cell(harness.load_json(bench.parent / "BENCHMARK.json"), workload, bench=bench)
