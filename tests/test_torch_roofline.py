"""The dry run's unit roofline and report (``repro_torch.launch.dryrun``'s
``model_flops``, ``assemble``, ``axis_bandwidths``, the counter's
collectives by mesh axis; ``repro_torch.launch.report``) against the
reference's functions on the CPU.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host
devices when it is imported, so its ``model_flops`` and ``assemble`` run in
a subprocess of their own.  Both are handed the same unit numbers; the
port's output must carry the reference's keys and values, with only the
hardware model swapped (the H100's, computed here from its constants) and
the collective bytes by mesh axis added.  The reference's cell itself
cannot run on every JAX version (an Explicit mesh); the port's run of it is
pinned by ``tests/test_torch_dryrun.py::test_main_runs_the_reference_tests_cell``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.launch import report as jreport
from repro.models import model_zoo as jz
from repro_torch.configs import get_arch, get_shape
from repro_torch.launch import dryrun, report

ROOT = Path(__file__).resolve().parents[1]
H100 = dict(peak=989e12, hbm=3.35e12, nvlink=450e9, nic=50e9)
# One arch of each kind, each with a shape of its own kind
KINDS = {"dense": "tinyllama-1.1b", "moe": "granite-moe-3b-a800m", "encdec": "whisper-medium",
         "vision": "internvl2-1b", "hybrid": "recurrentgemma-2b", "ssm": "xlstm-1.3b"}
SHAPE_OF = {"dense": "decode_32k", "moe": "train_4k", "encdec": "prefill_32k",
            "vision": "train_4k", "hybrid": "long_500k", "ssm": "prefill_32k"}


def units_of(seed: int):
    """Unit numbers of the reference's shape: (name, trips, flops, bytes,
    collective bytes by kind) and, for the port, the same bytes by axis."""
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
    out = []
    for i, (name, trips) in enumerate((("cycle_vg", 22 * 8), ("embed_head_vg", 8),
                                       ("optimizer", 1))):
        k = seed * 7 + i
        coll = {kind: (k + 1) * 1000 * (j + 1) if j != 4 else 0 for j, kind in enumerate(kinds)}
        total = sum(coll.values())
        by_axis = {"model": total // 2, "data": total // 4, "other": total - total // 2 - total // 4}
        out.append(dict(name=name, trips=trips, flops=1.5e12 * (k + 1), bytes=3.25e9 * (k + 2),
                        coll=coll, coll_by_axis=by_axis))
    return out


REFERENCE_CODE = """
import json, sys
from repro.configs import get_arch, get_shape
from repro.launch import dryrun
out = {}
for tag, (arch, shape, chips, units) in json.loads(sys.argv[1]).items():
    cfg, shp = get_arch(arch), get_shape(shape)
    us = [dryrun.UnitResult(u["name"], u["trips"], u["flops"], u["bytes"], u["coll"]) for u in units]
    out[tag] = {"model_flops": dryrun.model_flops(cfg, shp), "assemble": dryrun.assemble(us, chips, shp, cfg)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    cases = {kind: (arch, SHAPE_OF[kind], 256, units_of(i))
             for i, (kind, arch) in enumerate(KINDS.items())}
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", REFERENCE_CODE, json.dumps(cases)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return cases, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_model_flops_and_assemble_are_the_references_under_the_h100_model(kind, reference):
    """Given the reference's unit numbers (and the same bytes by axis),
    ``model_flops`` and ``assemble`` give the reference's keys and values;
    the terms are the H100 model's: FLOPs over 989 TFLOP/s, bytes over 3.35
    TB/s, each axis's collective bytes over its bandwidth (model 400 GB/s,
    data 50 GB/s, ``other`` at the NICs' 50 GB/s), summed."""
    cases, ref = reference
    arch, shape, chips, units = cases[kind]
    cfg, shp = get_arch(arch), get_shape(shape)
    us = [dryrun.UnitResult(**u) for u in units]
    bandwidths = {"data": H100["nic"], "model": 8 * H100["nic"]}
    got = json.loads(json.dumps(dryrun.assemble(us, chips, shp, cfg, bandwidths)))
    want = ref[kind]["assemble"]
    assert dryrun.model_flops(cfg, shp) == ref[kind]["model_flops"]
    assert set(got) == set(want)
    for key in ("model_flops_global", "hlo_flops_global", "model_over_hlo"):
        assert got[key] == want[key], key
    by_axis = got["per_device"].pop("collective_by_axis")
    assert got["per_device"] == want["per_device"]
    assert [{k: v for k, v in u.items() if k != "coll_by_axis"} for u in got["units"]] == want["units"]
    scaled = {a: sum(u["coll_by_axis"][a] * u["trips"] for u in units) for a in ("model", "data", "other")}
    assert by_axis == scaled
    terms = {"compute_s": want["per_device"]["flops"] / H100["peak"],
             "memory_s": want["per_device"]["bytes"] / H100["hbm"],
             "collective_s": scaled["model"] / (8 * H100["nic"]) + scaled["data"] / H100["nic"]
             + scaled["other"] / H100["nic"]}
    assert got["terms_seconds"] == pytest.approx(terms, rel=1e-12)
    assert got["dominant"] == max(terms, key=terms.get)
    assert got["roofline_bound_s"] == pytest.approx(max(terms.values()), rel=1e-12)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_model_flops_counts_the_reference_parameters(kind):
    """6 N tokens for training, 2 N tokens for prefill, 2 N a sequence for
    decode, N the reference's active parameter count."""
    arch = KINDS[kind]
    for shape_name, shape in JSHAPES.items():
        n = jz.param_count(JARCHS[arch], active_only=True)
        per = {"train": 6.0 * shape.global_batch * shape.seq_len,
               "prefill": 2.0 * shape.global_batch * shape.seq_len,
               "decode": 2.0 * shape.global_batch}[shape.kind]
        assert dryrun.model_flops(get_arch(arch), get_shape(shape_name)) == per * n


def test_the_hardware_model_is_the_h100s():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NVLINK_BW, dryrun.NIC_BW,
            dryrun.GPUS_PER_NODE) == (H100["peak"], H100["hbm"], H100["nvlink"], H100["nic"], 8)


def test_a_groups_bandwidth_is_nvlink_within_a_node_and_the_nics_across():
    """Eight ranks of one node share NVLink; sixteen over two nodes move 8
    x 50 GB/s a node (below NVLink's 450); one rank a node 50 GB/s; a
    lopsided group is held to its thinnest node."""
    assert dryrun.group_bandwidth(range(8)) == 450e9
    assert dryrun.group_bandwidth([0, 1]) == 450e9
    assert dryrun.group_bandwidth(range(16)) == 400e9
    assert dryrun.group_bandwidth(range(0, 256, 16)) == 50e9
    assert dryrun.group_bandwidth([0, 1, 2, 8]) == 50e9
    assert dryrun.group_bandwidth(range(0, 16, 2)) == 200e9


AXES_CODE = """
import json, torch, torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
dryrun.fake_world()
single = make_production_mesh(device_type="cpu")
multi = make_production_mesh(multi_pod=True, device_type="cpu")
other = dist.new_group([0, 1, 2, 3])
with FakeTensorMode():
    t = torch.empty(8, 16)
    c = dryrun.DeviceCounter(single)
    with c:
        fc.all_reduce(t, "sum", (single, 1))  # functional, over model
        dist.all_reduce(t, group=single.get_group(0))  # c10d in place, over data
        fc.all_gather_tensor(t, 0, (single, 0))
        fc.all_reduce(t, "sum", other)  # a group that is no mesh dim
print(json.dumps({"single": dryrun.axis_bandwidths(single), "multi": dryrun.axis_bandwidths(multi),
                  "coll": c.coll, "axis": c.coll_axis}))
"""


def test_collectives_are_counted_by_mesh_axis_and_priced_by_its_bandwidth():
    """On the production meshes the model axis (ranks 0-15, two nodes) moves
    400 GB/s, the data and pod axes (one rank a node) 50 GB/s.  The counter
    books each collective's bytes under the mesh dim whose group it runs
    on, functional or c10d in place, and one over a group that is no mesh
    dim under ``other``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", AXES_CODE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["single"] == {"data": 50e9, "model": 400e9}
    assert got["multi"] == {"pod": 50e9, "data": 50e9, "model": 400e9}
    one = 8 * 16 * 4
    assert got["coll"]["all-reduce"] == 3 * 2 * one and got["coll"]["all-gather"] == 16 * one
    assert got["axis"] == {"model": 2 * one, "data": 2 * one + 16 * one, "other": 2 * one}


ALLTOALL_CODE = """
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard
from repro_torch.distributed.sharding import PS
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
dryrun.fake_world()
mesh = make_production_mesh(device_type="cpu")
out = {}
with FakeTensorMode(allow_non_fake_inputs=True):
    meta = torch.empty(64, 32, 128, dtype=torch.bfloat16, device="meta")
    x = dryrun.placed(meta, PS("data", None, None), mesh, "cpu")
    c = dryrun.DeviceCounter(mesh)
    with c:  # DTensor's Shard(0) -> Shard(2) over data: gloo's all-gather and chunk
        y = x.redistribute(mesh, (Shard(2), Replicate()))
    out["redistribute"] = dict(coll=c.coll, axis=c.coll_axis, bytes=c.bytes,
                               local=list(y.to_local().shape))
    c = dryrun.DeviceCounter(mesh)
    with c:  # the op the card's mesh runs for it
        torch.ops._dtensor.shard_dim_alltoall(x.to_local(), 0, 2, mesh.get_group(0).group_name)
    out["op"] = dict(coll=c.coll, axis=c.coll_axis, bytes=c.bytes)
print(json.dumps(out))
"""


def test_an_all_to_all_is_counted_alike_on_both_device_types():
    """DTensor moves a split from one dim to another by
    ``_dtensor::shard_dim_alltoall`` on a CUDA mesh and by an all-gather and
    a chunk on a CPU mesh (gloo has no all-to-all).  The counter books both
    as one all-to-all of the local shard's bytes over the axis, which reads
    and writes as many bytes, so the two routes count alike."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", ALLTOALL_CODE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    shard = 64 // 16 * 32 * 128 * 2
    assert got["redistribute"]["local"] == [64, 32, 128 // 16]
    for case in ("redistribute", "op"):
        assert got[case]["coll"] == {"all-reduce": 0, "all-gather": 0, "reduce-scatter": 0,
                                     "all-to-all": shard, "collective-permute": 0}, case
        assert got[case]["axis"] == {"data": shard}, case
        assert got[case]["bytes"] == 2 * shard, case


def _cell():
    """One cell dict with a roofline, as the dry run writes it."""
    coll = {"all-reduce": 13131936.0, "all-gather": 720896.0, "reduce-scatter": 0.0,
            "all-to-all": 0.0, "collective-permute": 0.0}
    return {"cell": "tinyllama-1.1b__decode_32k__single", "chips": 256,
            "full": {"memory": {"peak_bytes_est": 551145548.0, "argument_bytes": 550031396.0,
                                "temp_bytes": 1114120.0}, "step_seconds": 4.1},
            "roofline": {"per_device": {"collective_breakdown": coll},
                         "terms_seconds": {"compute_s": 4.3814e-06, "memory_s": 1.858e-04,
                                           "collective_s": 3.4632e-05},
                         "dominant": "memory_s", "roofline_bound_s": 1.858e-04,
                         "model_flops_global": 2.816e11, "hlo_flops_global": 1.109e12,
                         "model_over_hlo": 0.2538}}


def test_the_report_renders_the_references_roofline_tables():
    """``roofline_table`` and ``collective_table`` are the reference's,
    character for character, on the same cells (a skipped one among them);
    ``dryrun_table`` heads its time column for the port's eager step.  The
    reference's report imports no JAX."""
    cells = [_cell(), {"cell": "x__long_500k__single", "skipped": "long_500k requires sub-quadratic decode"}]
    assert report.roofline_table(cells) == jreport.roofline_table(cells)
    assert report.collective_table(cells) == jreport.collective_table(cells)
    table = report.dryrun_table(cells)
    assert "step s (eager, fake)" in table.splitlines()[0]
    assert "| tinyllama-1.1b__decode_32k__single | 256 | 4.1 | 0.51 | 0.51 | 0.00 | - |" in table
    code = "import sys, repro.launch.report; assert 'jax' not in sys.modules"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, timeout=60).returncode == 0


def test_report_main_prints_the_three_tables(tmp_path, capsys):
    (tmp_path / "a.json").write_text(json.dumps(_cell()))
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("| tinyllama-1.1b__decode_32k__single |") == 3
    assert "**memory**" in out


TRAIN_CODE = """
import dataclasses, json, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import RunConfig, ShapeConfig, get_arch
from repro_torch.launch import dryrun
dryrun.fake_world()
cfg = dataclasses.replace(get_arch("smollm-135m"), num_layers=2)
shape = ShapeConfig("cut", seq_len=64, global_batch=8, kind="train")
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
run = RunConfig(model=cfg, shape=shape, optimizer_dtype="float32", remat="full")
full = dryrun.full_compile(cfg, run, shape, mesh)
units = dryrun.train_units(cfg, run, shape, mesh, full["num_microbatches"])
roof = dryrun.assemble(units, mesh.size(), shape, cfg, dryrun.axis_bandwidths(mesh))
print(json.dumps({"full": full, "roofline": roof}))
"""


def test_train_units_cover_a_cut_train_step():
    """Full-width smollm-135m cut to 2 layers, a train step of 8 x 64 tokens
    in 4 microbatches on a (2, 2) mesh, remat "full": the units are the
    reference's (``cycle_vg`` n_cycles x M, ``embed_head_vg`` M,
    ``optimizer`` once) and cover the step's FLOPs within 2 % (on torch 2.13:
    98.5 %; the step's backward runs 0.9e9 more product FLOPs), its
    all-gathers within 1 %, and 70-100 % of its bytes: the step's float32
    gradient accumulation (a cast, a product and a sum a leaf a
    microbatch, 12 % of its bytes) is in no unit, as in the reference.
    With FSDP the weights are gathered before their products, so neither
    moves activations by an all-to-all (which DTensor runs differently by
    device type)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", TRAIN_CODE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    full, roof = got["full"], got["roofline"]
    assert [(u["name"], u["trips"]) for u in roof["units"]] == [
        ("cycle_vg", 2 * 4), ("embed_head_vg", 4), ("optimizer", 1)]
    per = roof["per_device"]
    assert per["flops"] == pytest.approx(full["full_cost"]["flops"], rel=0.02)
    assert 0.7 < per["bytes"] / full["full_cost"]["bytes"] < 1.0
    assert per["collective_breakdown"]["all-gather"] == pytest.approx(
        full["full_coll"]["all-gather"], rel=0.01)
    assert per["collective_breakdown"]["all-to-all"] == 0 == full["full_coll"]["all-to-all"]
    assert set(per["collective_by_axis"]) <= {"data", "model", "other"}
    assert per["collective_by_axis"]["data"] > 0 and per["collective_by_axis"]["model"] > 0
