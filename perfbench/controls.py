"""Readings of a cell's check, for setting its limits (not run by a benchmark run).

    python3 perfbench/controls.py --workload <name> --seeds 1,2,3 --seconds 8

For each seed, in one process: set-up and a short window of the cell as a
run makes them, then the check's numbers twice at the same recorded
inputs: the program's (the lower readings) and the control's, the plain
reference in the precision below the configuration's in the program's place
(the upper readings).  One JSON line a seed.  Needs the card.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def readings(cell, seed: int, seconds: float, device) -> dict:
    import torch

    rec = harness.Record(seconds, False, device, time.perf_counter())
    samples = cell.driver.run(rec, cell.cfg, cell.mix, seed, device)
    gc.collect()
    torch.cuda.empty_cache()
    program = cell.driver.check(samples, cell.cfg, cell.mix, seed)
    control = cell.driver.check(samples, cell.cfg, cell.mix, seed, control=True)
    return dict(seed=seed, program=program, control=control, work=rec.work)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), args.workload)
    for s in args.seeds.split(","):
        out = readings(cell, int(s), args.seconds, torch.device("cuda", 0))
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
