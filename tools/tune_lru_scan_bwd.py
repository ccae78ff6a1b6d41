"""Time K3's backward (``lru_scan_bwd`` of ``csrc/lru_scan.cu``) at candidate
tiles on the card, to choose its tile (``BWD_CHUNK``, ``BWD_WIDTH`` in
``kernels/lru_scan.py``).

    python3 tools/tune_lru_scan_bwd.py [--tiles 64x32,32x32] [--parent DIR] [--json PATH]

Runs on an NVIDIA card only.  Each candidate C x W (C time steps by W
channels) is the repository's source built with ``-DLRU_SCAN_BWD_CHUNK=C
-DLRU_SCAN_BWD_WIDTH=W`` (a ``CudaKernel.variant`` of the entry point), all
builds at once, and launched by ``lru_scan_bwd_cuda`` with that build and
tile.  ``--parent DIR`` adds the backward of another ``lru_scan.cu`` (with
its ``tma.cuh`` beside it in DIR), such as the parent commit's, at its own
tile (``--parent-tile``, 128x32 by default).  Each candidate is first held
against ``lru_scan_backward_plain`` (1e-5 of the largest entry in float32,
4e-2 in bfloat16) at the training path's shape and one step past its own
chunk; ``chip_smoke.py``'s phase 3 checks the kept tile at every edge.  Then
each is timed as phase 4 times the kernel (CUDA-graph replays, float32,
input sets rotated past L2) at the training path's (2, 512, 2560) and the
serving path's prefill (4, 4096, 2560), in turns: every candidate in order,
then in reverse.  Prints the card's name and power limit, each candidate's
registers and spills (ptxas), its times and share of the bound, and with
``--json`` writes them all to PATH.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402
from repro_torch.kernels import lru_scan as k3  # noqa: E402

TRAIN, PREFILL = smoke.K3_TRAIN, smoke.K3_PATH


def tile(text: str):
    c, w = text.lower().split("x")
    return int(c), int(w)


def parity(kernel, tile_cw):
    """Worst error over the largest entry, against the plain version."""
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 1e-5, bf16: 4e-2}
    worst = 0.0
    for i, (shape, dt) in enumerate([(TRAIN, f32), ((2, tile_cw[0] + 1, 300), bf16)]):
        a, x, h0 = smoke.scan_case(*shape, seed=900 + i, dtype=dt, near_one=True)
        h = k3.lru_scan_plain(a, x, h0)
        dy = torch.randn(shape, generator=torch.Generator("cuda").manual_seed(950 + i),
                         device="cuda").to(dt)
        got = k3.lru_scan_bwd_cuda(a, h, h0, dy, kernel=kernel, tile=tile_cw)
        smoke.sync_within(60, f"the backward at {shape}")
        for g, w in zip(got, k3.lru_scan_backward_plain(a, h, h0, dy)[:2]):
            err, scale = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
            if not bool(torch.isfinite(g).all()) or err > tol[dt] * scale:
                raise AssertionError(f"{shape} {dt}: max|err| {err:.3e} over {tol[dt]:g} x "
                                     f"{scale:.3e}")
            worst = max(worst, err / scale)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", default="128x32,64x32,32x32,64x64,32x64,32x128")
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--parent-tile", default="128x32")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {smi}", flush=True)

    specs = {f"{c}x{w}": (k3._BWD_KERNEL.variant(
        flags=(f"-DLRU_SCAN_BWD_CHUNK={c}", f"-DLRU_SCAN_BWD_WIDTH={w}")), (c, w))
        for c, w in map(tile, args.tiles.split(","))}
    if args.parent is not None:
        specs["parent " + args.parent_tile] = (
            k3._BWD_KERNEL.variant(source=args.parent / "lru_scan.cu"), tile(args.parent_tile))
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        for future in [pool.submit(kernel.build) for kernel, _ in specs.values()]:
            future.result()
    out = {}
    for name, (kernel, tile_cw) in specs.items():
        usage = [line.strip() for line in kernel.ptxas().splitlines()
                 if "lru_scan_bwd_kernel" in line or "registers" in line or "spill" in line]
        out[name] = dict(ptxas=usage, parity=parity(kernel, tile_cw))
        print(f"[tune] {name}: ptxas {usage}; max|err| over the largest entry "
              f"{out[name]['parity']:.3e}", flush=True)

    sets = {TRAIN: smoke.scan_sets(TRAIN), PREFILL: smoke.scan_sets(PREFILL, n_sets=1)}
    # 3 operations an element; a, dy and h read, da and db written
    bounds = {shape: smoke.k3_bound(shape, 3, 2, 3)[0] for shape in sets}
    for name in list(specs) + list(reversed(specs)):
        kernel, tile_cw = specs[name]
        run = lambda a, x, h0, h, dy: k3.lru_scan_bwd_cuda(a, h, h0, dy, kernel=kernel,
                                                           tile=tile_cw)
        for shape, s in sets.items():
            ms = smoke.time_cuda(smoke.round_robin(run, s), runs=20)
            out[name].setdefault(str(shape), []).append(ms)
            print(f"[tune] {name} (B, T, R)={shape} float32: {ms:.4f} ms "
                  f"({100 * bounds[shape] / ms:.1f} % of the bound {bounds[shape]:.4f} ms)",
                  flush=True)
    for name in specs:
        line = ", ".join(f"{shape} median {statistics.median(out[name][str(shape)]):.4f} ms"
                         for shape in sets)
        print(f"[tune] {name}: {line}", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            dict(card=smi, bounds_ms={str(k): v for k, v in bounds.items()}, candidates=out),
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
