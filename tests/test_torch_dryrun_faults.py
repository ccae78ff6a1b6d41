"""Faults 3i, 3j and 3k of the port, pinned through its dry run on the CPU.

* 3i: xlstm-1.3b on a mesh.  Its mLSTM's q, k, v and output-gate products
  split 4 heads unevenly over a model axis of 16, their gradients met
  strides DTensor cannot view, log sigmoid's backward had no sharding
  strategy, and a decode at one sequence reshaped a dim DTensor held split.
  Full-width xlstm-1.3b cut in depth (8 layers: 7 mLSTM and 1 sLSTM; 2
  layers: 2 mLSTM) runs through the dry run on the meshes where it failed,
  and on those where it ran; its full (16, 16) ``long_500k`` cell (one
  decode step of one sequence) runs through ``python -m
  repro_torch.launch.dryrun``.
* 3k: training attention whose KV heads the model axis does not divide (4
  of tinyllama's over 16; 3 of smollm's) failed in the backward: DTensor
  split the heads x hd of a product's gradient through a head, and the
  view back to the heads refused it.  The projections and the output
  product run shard by shard (``layers.heads_product``).  One full-width
  layer of each trains on the (16, 16) mesh, smollm's at 4096 tokens.
* 3j: a vocab-split embedding lookup gathered the whole table: pinned by
  ``tests/test_torch_dryrun.py::test_main_runs_the_reference_tests_cell``
  (the cell's all-gather under 1 MB) and, bitwise on 4 gloo ranks, by
  ``tests/test_torch_model_sharding.py::test_a_vocab_split_lookup_is_bitwise_the_whole_tables``.

Every case runs in one subprocess: one fake world of 512 ranks, torch on
one thread.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# (arch, layers, kind, seq_len, global_batch, mesh), each arch at full width
CUTS = {
    "xlstm-train-8-2x2": ("xlstm-1.3b", 8, "train", 64, 4, (2, 2)),
    "xlstm-train-8-2x16": ("xlstm-1.3b", 8, "train", 64, 4, (2, 16)),
    "xlstm-train-8-1x4": ("xlstm-1.3b", 8, "train", 64, 4, (1, 4)),
    "xlstm-decode-8-batch1-2x16": ("xlstm-1.3b", 8, "decode", 64, 1, (2, 16)),
    "xlstm-train-2-2x2": ("xlstm-1.3b", 2, "train", 64, 8, (2, 2)),
    "xlstm-decode-8-2x16": ("xlstm-1.3b", 8, "decode", 64, 4, (2, 16)),  # ran before
    "xlstm-prefill-8-2x16": ("xlstm-1.3b", 8, "prefill", 64, 4, (2, 16)),  # ran before
    # fault 3k: trained attention whose KV heads (4 of 32; 3 of 9) the model
    # axis of 16 does not divide; smollm at train_4k's 4096 tokens, two
    # query chunks
    "tinyllama-train-1-16x16": ("tinyllama-1.1b", 1, "train", 64, 16, (16, 16)),
    "smollm-train-1-seq4096-16x16": ("smollm-135m", 1, "train", 4096, 16, (16, 16)),
}
CODE = """
import dataclasses, json, sys, tempfile, pathlib, torch
torch.set_num_threads(1)
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch import dryrun
out = {}
for name, (arch, layers, kind, seq, batch, mesh) in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    shape = ShapeConfig("cut", seq_len=seq, global_batch=batch, kind=kind)
    try:
        out[name] = dryrun.cut_cell(cfg, shape, tuple(mesh), device="cpu")
    except Exception as e:
        out[name] = {"error": f"{type(e).__name__}: {e}"}
d = pathlib.Path(tempfile.mkdtemp())
dryrun.main(["--arch", "xlstm-1.3b", "--shape", "long_500k", "--mesh", "single", "--device",
             "cpu", "--no-units", "--out", str(d), "--force"])
out["long_500k"] = json.loads((d / "xlstm-1.3b__long_500k__single.json").read_text())
print(json.dumps(out))
"""


def run_port(code: str, timeout: float):
    """``code`` in a subprocess with the port on the path; the JSON of its
    last printed line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cells():
    return run_port(CODE.replace("sys.argv[1]", repr(json.dumps(CUTS))), timeout=600)


@pytest.mark.parametrize("name", sorted(CUTS))
def test_cut_cells_run_on_the_meshes_where_they_failed(name, cells):
    """Each cut case runs and counts work; a train step runs global_batch /
    data microbatches, and where the data axis splits (FSDP) its gradients
    are reduce-scattered over it."""
    arch, layers, kind, seq, batch, mesh = CUTS[name]
    r = cells[name]
    assert "error" not in r, r.get("error")
    assert r["full_cost"]["flops"] > 0 and r["memory"]["peak_bytes_est"] > 0
    if kind == "train":
        assert r["num_microbatches"] == batch // mesh[0]
        if mesh[0] > 1:
            assert r["full_coll"]["reduce-scatter"] > 0


def test_the_full_xlstm_long_500k_cell_runs_on_the_production_mesh(cells):
    """xlstm-1.3b's ``long_500k`` cell at full width and depth (48 layers) on
    the (16, 16) mesh: one decode step of one sequence, replicated over the
    data axis, with a state of 524 288 tokens behind it."""
    cell = cells["long_500k"]
    assert cell["chips"] == 256 and cell["mesh"] == {"data": 16, "model": 16}
    full = cell["full"]
    assert full["full_cost"]["flops"] > 0 and full["memory"]["peak_bytes_est"] > 0
    assert full["kernel_calls"] == {}
