"""The port's dry run (``repro_torch.launch.dryrun``), its meshes
(``repro_torch.launch.mesh``) and ``optim.adamw.abstract_state``, against the
reference on the CPU.

A process holds one default process group, so every case that starts the
dry run's fake world (512 ranks, ``init_process_group("fake")``) runs in a
subprocess of its own and prints its results as JSON.  The kernels' custom
ops are counted in this process, under ``FakeTensorMode`` on CPU tensors.

* the production meshes' names and shapes, ``batch_axes`` and
  ``model_axis``, against the reference's (its meshes made in a JAX
  subprocess of 512 host devices);
* ``abstract_state`` against the reference's on every leaf of smollm-135m;
* the per-device counter: the probe's sharded product counts one shard's
  FLOPs, the sharding propagator's global product none; one all-gather's
  bytes, an all-reduce twice;
* K2, K3 and K3's backward as one counted operation each (the shape rule,
  the bound's formula) and their CPU implementations bitwise the plain
  versions;
* ``main`` on the reference test's cell (tinyllama-1.1b decode_32k on the
  single mesh), its argument bytes those of the reference layout's local
  shards; reduced train and prefill cells on a (2, 2) mesh; the cell's
  optimizer dtype above 2e11 parameters.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.distributed import sharding as jshd
from repro.models import model_zoo as jz, transformer as jt
from repro.optim import adamw as jadamw
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as k2
from repro_torch.kernels import lru_scan as k3
from repro_torch.launch import dryrun
from repro_torch.models import model_zoo as tz
from repro_torch.models.params import leaves
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
CELL = ("tinyllama-1.1b", "decode_32k", "single")
# The probe: (128 x 2048) @ (2048 x 5632) placed (Shard(0), Replicate()) and
# (Replicate(), Shard(1)) on the 16 x 16 mesh: one rank's (8 x 2048) @ (2048 x 352)
LOCAL_FLOPS, GLOBAL_FLOPS = 2 * 8 * 2048 * 352, 2 * 128 * 2048 * 5632


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_port(code: str, timeout: float = 300.0):
    """``code`` in a subprocess with the port on the path; the JSON of its
    last printed line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# --------------------------------------------------------------------------
# the meshes
# --------------------------------------------------------------------------
def test_production_meshes_match_the_reference():
    """Both production meshes over the fake world: the reference's axis
    names and shape, and ``batch_axes`` / ``model_axis`` as the reference's
    functions give them on the reference's meshes; the host mesh is the
    whole world on one data axis."""
    got = run_port(
        "import json\n"
        "from repro_torch.launch import dryrun, mesh as m\n"
        "dryrun.fake_world()\n"
        "out = {}\n"
        "for multi in (False, True):\n"
        "    x = m.make_production_mesh(multi_pod=multi, device_type='cpu')\n"
        "    out[str(multi)] = [list(x.mesh_dim_names), list(x.shape), list(m.batch_axes(x)),\n"
        "                       m.model_axis(x), x.size()]\n"
        "h = m.make_host_mesh('cpu')\n"
        "out['host'] = [list(h.mesh_dim_names), list(h.shape), list(m.batch_axes(h)), m.model_axis(h)]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    code = ("import json\n"
            "from repro.launch import mesh as m\n"
            "out = {}\n"
            "for multi in (False, True):\n"
            "    x = m.make_production_mesh(multi_pod=multi)\n"
            "    out[str(multi)] = [list(x.axis_names), list(x.devices.shape), list(m.batch_axes(x)),\n"
            "                       m.model_axis(x), x.size]\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["False"] == want["False"] == [["data", "model"], [16, 16], ["data"], "model", 256]
    assert got["True"] == want["True"] == [["pod", "data", "model"], [2, 16, 16],
                                           ["pod", "data"], "model", 512]
    assert got["host"] == [["data"], [512], ["data"], None]


# --------------------------------------------------------------------------
# abstract_state
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_abstract_state_matches_the_reference_on_every_leaf(dtype):
    """m and v of every smollm-135m leaf in ``dtype`` and an int32 count,
    shape-only (meta, or fake under ``FakeTensorMode``), as the reference's
    ``abstract_state``."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    name = "smollm-135m"
    want = jadamw.abstract_state(jz.abstract_model_params(JARCHS[name]), getattr(jnp, dtype))
    got = adamw.abstract_state(tz.abstract_model_params(get_arch(name)), getattr(torch, dtype))
    for jtree, ttree in ((want.m, got.m), (want.v, got.v)):
        jl, tl = jax.tree_util.tree_leaves(jtree), leaves(ttree)
        assert len(jl) == len(tl) > 0
        for j, t in zip(jl, tl):
            assert tuple(t.shape) == tuple(j.shape) and t.device.type == "meta"
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
    assert got.count.shape == () and got.count.dtype == torch.int32 and want.count.dtype == jnp.int32
    with FakeTensorMode():
        fake = adamw.abstract_state(
            {"w": torch.empty((4, 3), dtype=torch.bfloat16)}, getattr(torch, dtype))
    assert isinstance(fake.m["w"], FakeTensor) and fake.v["w"].dtype == getattr(torch, dtype)


# --------------------------------------------------------------------------
# the per-device counter
# --------------------------------------------------------------------------
COUNTER_CODE = """
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
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    a = dryrun.placed(meta(128, 2048), PS("data", None), mesh, "cpu")
    b = dryrun.placed(meta(2048, 5632), PS(None, "model"), mesh, "cpu")
    for call in ("first", "cached"):
        c = dryrun.DeviceCounter()
        held = c.hold((a, b))
        with c:
            y = a @ b
        out[call] = dict(flops=c.flops, peak=c.peak_bytes, held=held, coll=c.coll,
                         local=list(y.to_local().shape), placements=str(y.placements))
    c = dryrun.DeviceCounter()
    with c:
        y.redistribute(mesh, (Shard(0), Replicate()))
    out["all_gather"] = c.coll
    c = dryrun.DeviceCounter()
    with c:
        y.sum().full_tensor()
    out["all_reduce"] = c.coll
print(json.dumps(out))
"""


def test_the_counter_counts_one_rank_not_the_propagators_global_product():
    """The probe's product on the 16 x 16 mesh counts one rank's FLOPs, on
    its first call (when DTensor's propagator runs it on global fake
    tensors) and on a cached one; the peak is the three local shards'
    bytes; gathering the (8, 352) shard over the 16 model ranks counts
    16 x 8 x 352 bf16 bytes once, and the sum's all-reduce of a bf16 scalar
    over each of the two mesh dims 2 x 2."""
    got = run_port(COUNTER_CODE)
    local_bytes = 2 * (8 * 2048 + 2048 * 352 + 8 * 352)
    for call in ("first", "cached"):
        c = got[call]
        assert c["flops"] == LOCAL_FLOPS == 11_534_336 != GLOBAL_FLOPS
        assert c["local"] == [8, 352] and c["placements"] == "(Shard(dim=0), Shard(dim=1))"
        assert c["held"] == 2 * (8 * 2048 + 2048 * 352) and c["peak"] == local_bytes
        assert sum(c["coll"].values()) == 0
    assert got["all_gather"] == dict(dict.fromkeys(dryrun.COLL_KINDS, 0),
                                     **{"all-gather": 16 * 8 * 352 * 2})
    assert got["all_reduce"] == dict(dict.fromkeys(dryrun.COLL_KINDS, 0), **{"all-reduce": 2 * (2 * 2)})


# --------------------------------------------------------------------------
# the kernels as counted operations
# --------------------------------------------------------------------------
def _k2_inputs(seed=0, b=2, h=8, kvh=2, d=16, s=40):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, h, d), generator=g)
    k, v = (torch.randn((b, s, kvh, d), generator=g) for _ in range(2))
    return q, k, v, torch.tensor([s, 17], dtype=torch.int32)


def _k3_inputs(seed=0, b=2, t=9, r=5):
    g = torch.Generator().manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, t, r), generator=g))
    x, h0, dy = torch.randn((b, t, r), generator=g), torch.randn((b, r), generator=g), \
        torch.randn((b, t, r), generator=g)
    return a, x, h0, dy


KERNEL_CASES = {
    "decode_attention": (lambda: _k2_inputs(), lambda q, k, v, n: k2.decode_attention(q, k, v, n),
                         lambda q, k, v, n: k2.decode_attention_plain(q, k, v, n),
                         lambda q, k, v, n: k2.work(q, k, v, n)),
    "decode_attention_lse": (
        lambda: _k2_inputs(1), lambda q, k, v, n: k2.decode_attention(q, k, v, n, return_lse=True),
        lambda q, k, v, n: k2.decode_attention_plain(q, k, v, n, return_lse=True),
        lambda q, k, v, n: k2.work(q, k, v, n, return_lse=True)),
    "lru_scan": (lambda: _k3_inputs()[:3], k3.lru_scan, k3.lru_scan_plain, k3.work),
    "lru_scan_bwd": (
        lambda: (lambda a, x, h0, dy: (a, k3.lru_scan_plain(a, x, h0), h0, dy))(*_k3_inputs(2)),
        torch.ops.repro_torch.lru_scan_bwd, k3.lru_scan_backward_plain, k3.backward_work),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_a_kernel_is_one_counted_operation_with_its_bounds_formula(name):
    """Under ``FakeTensorMode`` on CPU tensors each kernel entry point is one
    operation of the counter: the kernel's call counted once, its FLOPs and
    bytes the bound's formula (nothing of the plain version's scores), its
    outputs the shape rule's; on real CPU tensors the op is bitwise the
    plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    make, op, plain, work = KERNEL_CASES[name]
    real = make()
    got, want = op(*real), plain(*real)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert torch.equal(g, w)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(x) for x in real]
        counter = dryrun.DeviceCounter()
        with counter:
            out = op(*fake)
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    assert [(tuple(o.shape), o.dtype) for o in outs] == [(tuple(w.shape), w.dtype) for w in wants]
    kernel = "decode_attention" if name.startswith("decode") else name
    assert counter.kernel_calls == {kernel: 1}
    flops, nbytes = work(*real)
    assert (counter.flops, counter.bytes) == (flops, nbytes) and flops > 0
    if name == "decode_attention":  # q, every K and V row, the lengths, the output
        q, k, v, n = real
        assert nbytes == 4 * (2 * q.numel() + k.numel() + v.numel() + n.numel())
        assert flops == 4.0 * 2 * 8 * 40 * 16


def test_k3_under_autograd_is_counted_forward_and_backward():
    """``lru_scan`` on fake tensors that require a gradient: the forward and
    the backward custom op each counted once (``LruScan`` around them)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    a, x, h0, dy = _k3_inputs()
    with FakeTensorMode() as mode:
        a, x, h0, dy = (mode.from_tensor(t).requires_grad_(t is not dy) for t in (a, x, h0, dy))
        counter = dryrun.DeviceCounter()
        with counter:
            h = k3.lru_scan(a, x, h0)
            torch.autograd.grad(h, (a, x, h0), dy)
    assert counter.kernel_calls == {"lru_scan": 1, "lru_scan_bwd": 1}


# --------------------------------------------------------------------------
# the cells
# --------------------------------------------------------------------------
def _local_bytes(shape, spec, mesh, itemsize) -> int:
    n = math.prod(shape)
    for entry in spec:
        for a in () if entry is None else (entry,) if isinstance(entry, str) else entry:
            n //= mesh.shape[a]
    return n * itemsize


def reference_argument_bytes(arch, shape_name, mesh) -> int:
    """The local shard bytes of every parameter, input and cache leaf of a
    decode cell under the reference's ``spec_for``: parameters by the
    default rules without FSDP, the token's batch over the data axes, the
    cache by the cache rules."""
    cfg, shape = JARCHS[arch], JSHAPES[shape_name]
    is_axes = lambda x: isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)
    total = 0
    for tree, axes, rules in (
            (jz.abstract_model_params(cfg), jz.model_axes(cfg), jshd.default_rules(mesh, fsdp=False)),
            (jz.abstract_cache(cfg, shape), jt.cache_axes_tree(cfg), jshd.cache_rules(mesh))):
        for a, ax in zip(jax.tree_util.tree_leaves(tree),
                         jax.tree_util.tree_leaves(axes, is_leaf=is_axes)):
            total += _local_bytes(a.shape, jshd.spec_for(a.shape, ax, mesh, rules), mesh,
                                  jnp.dtype(a.dtype).itemsize)
    token = (shape.global_batch, 1)
    return total + _local_bytes(token, (("data",), None), mesh, 4)


class FakeMesh:
    """A mesh's names and sizes alone, as tests/test_torch_model_sharding.py's."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


def test_main_runs_the_reference_tests_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the reference test's cell
    with ``--device cpu``: 256 chips on the (16, 16) mesh, per-device FLOPs
    and a peak above 0, K2 once a layer, argument bytes equal to the local
    shard bytes of the reference's layout on a ``FakeMesh(data=16,
    model=16)``, and the embedding looked up on each shard of the
    vocab-split table (fault 3j: the all-gather under 1 MB, where gathering
    the table moved 131 072 000 B).

    The roofline holds the reference test's conditions: memory-bound, a
    bound under 50 ms, FLOPs above 0.  tinyllama has 22 one-layer cycles and
    no ``rest``, so the units (22 x ``cycle_decode``, ``embed_head_decode``)
    cover the whole step: their scaled FLOPs equal ``full_cost``'s (on
    torch 2.13: exactly), their bytes come within 0.1 % (0.03 %: the step's final
    norm reads the last cycle's output, the unit's head a sum), and their
    collective bytes within 3 % by kind (1.9 % of the all-reduce: the step
    reduces the last cycle's partial sums inside its final norm, in float32,
    where a unit makes its output whole in bfloat16); the all-gather equal."""
    arch, shape, mesh = CELL
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                           "--shape", shape, "--mesh", mesh, "--device", "cpu",
                           "--out", str(tmp_path), "--force"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    cell = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json").read_text())
    assert cell["chips"] == 256 and cell["mesh"] == {"data": 16, "model": 16}
    full = cell["full"]
    mem = full["memory"]
    assert full["full_cost"]["flops"] > 0 and full["full_cost"]["bytes"] > 0
    assert mem["peak_bytes_est"] > 0 and mem["alias_bytes"] == 0
    assert mem["peak_bytes_est"] == mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
    assert full["kernel_calls"] == {"decode_attention": get_arch(arch).num_layers}
    assert mem["argument_bytes"] == reference_argument_bytes(arch, shape,
                                                             FakeMesh(data=16, model=16))
    assert full["full_coll"]["all-gather"] < 1_000_000
    roof = cell["roofline"]
    assert roof["dominant"] == "memory_s" and roof["roofline_bound_s"] < 0.05
    per = roof["per_device"]
    assert per["flops"] > 0
    assert [(u["name"], u["trips"]) for u in roof["units"]] == [("cycle_decode", 22),
                                                                ("embed_head_decode", 1)]
    assert per["flops"] == pytest.approx(full["full_cost"]["flops"], rel=0.01)
    assert per["bytes"] == pytest.approx(full["full_cost"]["bytes"], rel=0.001)
    for kind, n in full["full_coll"].items():
        assert per["collective_breakdown"][kind] == pytest.approx(n, rel=0.03), kind
    assert per["collective_breakdown"]["all-gather"] == full["full_coll"]["all-gather"]
    assert set(per["collective_by_axis"]) == {"model"}  # decode's collectives: all over model
    assert sum(per["collective_by_axis"].values()) == per["collective_bytes"]
    assert roof["terms_seconds"]["collective_s"] == pytest.approx(
        per["collective_by_axis"]["model"] / 400e9)


CUT_CODE = """
import dataclasses, json, sys
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch import dryrun
arch, layers, kind, seq, batch = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
shape = ShapeConfig("cut", seq_len=seq, global_batch=batch, kind=kind)
print(json.dumps(dryrun.cut_cell(cfg, shape, (2, 2), device="cpu")))
"""
# (arch, layers, kind, seq_len, global_batch): smollm-135m at full width cut
# to 2 layers; recurrentgemma-2b to one cycle (two RG-LRU layers and an
# attention layer), whose scans run K3 and, in training, its backward
CUTS = {"smollm-train": ("smollm-135m", 2, "train", 64, 8),
        "smollm-prefill": ("smollm-135m", 2, "prefill", 64, 4),
        "recurrentgemma-train": ("recurrentgemma-2b", 3, "train", 64, 4)}


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_cut_cells_run_through_on_a_two_by_two_mesh(cut):
    """Reduced train and prefill cells on a (2, 2) fake mesh run through:
    a train step in global_batch / 2 microbatches with float32 moments (a
    fresh copy of parameters and moments as its output), a prefill writing
    the cache in place; collectives over both axes; the hybrid's scans
    counted as K3 (its forward and remat's recompute) and its backward."""
    arch, layers, kind, seq, batch = CUTS[cut]
    r = run_port(CUT_CODE.replace("sys.argv[1]", repr(json.dumps(CUTS[cut]))))
    mem = r["memory"]
    assert r["full_cost"]["flops"] > 0 and mem["argument_bytes"] > 0
    assert mem["peak_bytes_est"] >= mem["argument_bytes"] + mem["output_bytes"]
    assert r["full_coll"]["all-reduce"] > 0
    if kind == "train":
        assert r["num_microbatches"] == batch // 2
        assert r["full_coll"]["reduce-scatter"] > 0  # FSDP's gradients
        assert mem["output_bytes"] > 0.9 * mem["argument_bytes"]  # params and moments anew
    else:
        # the tokens, the batch over the data axis of 2
        assert "num_microbatches" not in r and mem["output_bytes"] == batch // 2 * 4
    if arch == "recurrentgemma-2b":  # 2 RG-LRU layers a microbatch, under remat "full"
        m = batch // 2
        assert r["kernel_calls"] == {"lru_scan": 2 * 2 * m, "lru_scan_bwd": 2 * m}
    else:
        assert r["kernel_calls"] == {}


def test_a_cell_above_2e11_parameters_takes_bfloat16_moments():
    """The cell's AdamW moments are bfloat16 above 2e11 parameters (arctic-480b),
    as the reference's ``run_cell`` picks them, and float32 below."""
    for name in ("arctic-480b", "tinyllama-1.1b", "command-r-35b"):
        want = "bfloat16" if jz.param_count(JARCHS[name]) > 2e11 else "float32"
        assert dryrun.optimizer_dtype(get_arch(name)) == want
    assert dryrun.optimizer_dtype(get_arch("arctic-480b")) == "bfloat16"
