"""Render the dry run's JSON cells into the roofline tables.

The port's counterpart of ``repro.launch.report``: the same three tables on
the same cell dicts.  The dry-run table's time column is the port's
``step_seconds`` (one eager run of the step on fake tensors), where the
reference's is its compile time; the roofline and collective tables are the
reference's, character for character.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional


def load_cells(d: pathlib.Path) -> List[Dict]:
    return [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]


def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def dryrun_table(cells: List[Dict]) -> str:
    rows = [
        "| cell | chips | step s (eager, fake) | peak GiB/dev | args GiB | temps GiB | microbatches |",
        "|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if "skipped" in c:
            rows.append(f"| {c['cell']} | - | - | SKIP: {c['skipped']} | | | |")
            continue
        m = c["full"]["memory"]
        rows.append(
            f"| {c['cell']} | {c['chips']} | {c['full'].get('step_seconds','-')} "
            f"| {fmt_bytes(m['peak_bytes_est'])} | {fmt_bytes(m['argument_bytes'])} "
            f"| {fmt_bytes(m['temp_bytes'])} | {c['full'].get('num_microbatches','-')} |"
        )
    return "\n".join(rows)


def roofline_table(cells: List[Dict]) -> str:
    rows = [
        "| cell | compute s | memory s | collective s | dominant | bound ms "
        "| MODEL_FLOPS | HLO_FLOPS | model/hlo |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        r = c.get("roofline")
        if not r:
            continue
        t = r["terms_seconds"]
        rows.append(
            f"| {c['cell']} | {t['compute_s']:.3f} | {t['memory_s']:.3f} "
            f"| {t['collective_s']:.3f} | **{r['dominant'].replace('_s','')}** "
            f"| {1e3 * r['roofline_bound_s']:.1f} "
            f"| {r['model_flops_global']:.2e} | {r['hlo_flops_global']:.2e} "
            f"| {r['model_over_hlo']:.3f} |"
        )
    return "\n".join(rows)


def collective_table(cells: List[Dict]) -> str:
    rows = [
        "| cell | all-reduce GiB | all-gather GiB | reduce-scatter GiB "
        "| all-to-all GiB | permute GiB |",
        "|---|---|---|---|---|---|",
    ]
    for c in cells:
        r = c.get("roofline")
        if not r:
            continue
        b = r["per_device"]["collective_breakdown"]
        rows.append(
            f"| {c['cell']} | {fmt_bytes(b['all-reduce'])} | {fmt_bytes(b['all-gather'])} "
            f"| {fmt_bytes(b['reduce-scatter'])} | {fmt_bytes(b['all-to-all'])} "
            f"| {fmt_bytes(b['collective-permute'])} |"
        )
    return "\n".join(rows)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    cells = load_cells(pathlib.Path(args.dir))
    print("## Dry-run (full steps, eager on fake tensors)\n")
    print(dryrun_table(cells))
    print("\n## Roofline (single-pod unit decomposition, H100 model)\n")
    print(roofline_table(cells))
    print("\n## Collective breakdown (per device per step)\n")
    print(collective_table(cells))


if __name__ == "__main__":
    main()
