"""Phase 7's decode (``chip_smoke.phase_serve``: full-width recurrentgemma-2b,
batch 4, 4096-token prompts, 32 tokens) of two trees of the repository on
one card, in turns, and the host's cost of one K2 call through its entry
point beside the raw launcher.

    python3 tools/ab_decode.py --parent DIR [--rounds 2]

Runs on an NVIDIA card only.  ``DIR`` holds another tree (the parent
commit's, unpacked by ``git archive``).  Each phase runs in a process of
its own, parent, this tree, this tree, parent (``--rounds`` pairs), and its
``[serve]`` lines are printed under the tree's name.  Then, in this tree,
K2 at phase 7's decode shape is called 2000 times through
``kernels.decode_attention.decode_attention`` (the custom op) and through
``decode_attention_cuda`` (the launcher it runs), the host's microseconds a
call measured before one synchronisation, in turns.  Prints the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SERVE = ("import chip_smoke as c; c.phase_environment(); c.phase_build(); "
         "print(c.phase_serve())")


def serve_lines(tree: Path) -> list:
    proc = subprocess.run([sys.executable, "-c", SERVE], cwd=tree, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(tree / "src")), timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{tree}: {proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    return [line for line in proc.stdout.splitlines() if line.startswith("[serve] batch")]


def host_us_a_call(calls: int = 2000, turns: int = 3) -> dict:
    """Host microseconds a K2 call at phase 7's shape: the entry point (one
    custom op) and the raw launcher, in turns; each the median of ``turns``."""
    import statistics

    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)
    import torch
    from repro_torch.kernels import decode_attention as k2

    q, k, v, n = smoke.decode_case(*smoke.K2_PATH, seed=7, q_dtype=torch.bfloat16,
                                   kv_dtype=torch.float32)
    fns = {"entry point (custom op)": lambda: k2.decode_attention(q, k, v, n),
           "raw launcher": lambda: k2.decode_attention_cuda(q, k, v, n)}
    got = {name: [] for name in fns}
    with torch.no_grad():
        for _ in range(turns):
            for name, fn in list(fns.items()) + list(reversed(fns.items())):
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                host = time.perf_counter() - t0
                torch.cuda.synchronize()
                got[name].append(host / calls * 1e6)
    return {name: statistics.median(us) for name, us in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    order = []
    for _ in range(args.rounds // 2 or 1):
        order += [("parent", args.parent.resolve()), ("change", ROOT), ("change", ROOT),
                  ("parent", args.parent.resolve())]
    for tag, tree in order:
        for line in serve_lines(tree):
            print(f"[ab-decode] {tag}: {line}", flush=True)
    for name, us in host_us_a_call().items():
        print(f"[ab-decode] K2 at phase 7's shape, host us a call, {name}: {us:.2f}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
