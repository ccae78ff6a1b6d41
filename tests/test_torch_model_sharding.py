"""Model-tensor sharding (``repro_torch.distributed.sharding`` and the model
stack's mesh hooks) against the reference's on the CPU.

Without a world: the rules engine (``spec_for`` under the default and cache
rules) against ``repro.distributed.sharding`` on every leaf of every
registered arch at full size, on stand-in meshes; the shape-only trees
(``abstract_model_params``, ``abstract_cache``, ``input_specs``); K2's
log-sum-exp output and the merge of a cache split by rows.

With a world: one module-scoped world of 4 gloo ranks
(``torch_model_sharding_world.run_world``) runs the port on (2, 2) and
(1, 4) ("data", "model") meshes and unsharded, and beside it one JAX process
of 4 host devices runs the reference's sharded calls on the same numpy
weights and inputs.  The tests read both.

Tolerances, float32:

* logits at the model tests' ``MODEL_TOL`` (rtol 1e-4, atol 2e-5;
  ``tests/test_torch_models.py``): a mesh sums the same products in another
  order (partial sums over the model axis, the vocab and heads split);
  measured up to 3e-6 on logits of magnitude 10;
* the caches after decode within 1e-5 of the unsharded ones;
* gradients within 1e-5 of a leaf's largest entry, losses at rtol 1e-5
  (``tests/test_torch_train_step.py``, ``tests/test_torch_trainer.py:203``);
* checkpoints moved between a sharded and an unsharded trainer bitwise.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_model_sharding_world as world
from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES
from repro.distributed import sharding as jshd
from repro.models import model_zoo as jz, transformer as jt
from repro.models.params import param_bytes as jbytes
from repro_torch.configs import SHAPES, get_arch
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.models import model_zoo as tz, transformer as tt
from repro_torch.models.params import leaves, param_bytes

ROOT = Path(__file__).resolve().parents[1]
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
GRAD_REL = 1e-5
LOSS_RTOL = 1e-5


# --------------------------------------------------------------------------
# the rules, on stand-in meshes (no world)
# --------------------------------------------------------------------------
class FakeMesh:
    """A mesh's names and sizes alone, as tests/test_runtime.py's."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


MESHES = {"16x16": FakeMesh(data=16, model=16), "2x2": FakeMesh(data=2, model=2),
          "pod": FakeMesh(pod=2, data=16, model=16)}
RULES = {"fsdp": lambda m, s: s.default_rules(m, fsdp=True),
         "tp": lambda m, s: s.default_rules(m, fsdp=False),
         "cache": lambda m, s: s.cache_rules(m)}


def _jleaves(tree, is_leaf=None):
    return jax.tree_util.tree_leaves(tree, is_leaf=is_leaf)


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_spec_for_matches_reference_on_every_leaf(name, mesh):
    """Every parameter leaf (under the default rules with and without FSDP)
    and every decode-cache leaf (under the cache rules, and the default
    rules) of the full-size arch gets the reference's spec."""
    m = MESHES[mesh]
    jcfg, tcfg = JARCHS[name], get_arch(name)
    params = (_jleaves(jz.abstract_model_params(jcfg)), _jleaves(jz.model_axes(jcfg), _is_axes),
              leaves(tz.abstract_model_params(tcfg)), leaves(tz.model_axes(tcfg)))
    shape = JSHAPES["decode_32k"]
    caches = (_jleaves(jz.abstract_cache(jcfg, shape)), _jleaves(jt.cache_axes_tree(jcfg), _is_axes),
              leaves(tz.abstract_cache(tcfg, SHAPES["decode_32k"])), leaves(tt.cache_axes_tree(tcfg)))
    for rules, (jabs, jaxes, tabs, taxes) in (("fsdp", params), ("tp", params),
                                             ("cache", caches), ("fsdp", caches)):
        assert len(jabs) == len(tabs) and list(jaxes) == list(taxes)
        for ja, ax, ta in zip(jabs, jaxes, tabs):
            assert tuple(ja.shape) == tuple(ta.shape) and ta.device.type == "meta"
            want = jshd.spec_for(ja.shape, ax, m, RULES[rules](m, jshd))
            got = shd.spec_for(ta.shape, ax, m, RULES[rules](m, shd))
            assert tuple(got) == tuple(want), (rules, ax, ta.shape)


def test_tree_and_cache_shardings_match_reference_specs():
    jcfg, tcfg = JARCHS["granite-moe-3b-a800m"], get_arch("granite-moe-3b-a800m")
    m = MESHES["16x16"]
    want = jax.tree_util.tree_map(
        lambda a, ax: tuple(jshd.spec_for(a.shape, ax, m, jshd.default_rules(m))),
        jz.abstract_model_params(jcfg), jz.model_axes(jcfg), is_leaf=None)
    got = shd.tree_shardings(tz.abstract_model_params(tcfg), tz.model_axes(tcfg), m)
    assert [tuple(s) for s in leaves(got)] == [tuple(s) for s in _jleaves(want, _is_axes)]
    cache = shd.cache_shardings(tz.abstract_cache(tcfg, SHAPES["decode_32k"]),
                                tt.cache_axes_tree(tcfg), m)
    # 8 KV heads on 16 shards: the seq fallback (flash-decode), batch over data
    assert tuple(cache["cycles"][0]["k"]) == (None, "data", "model", None, None)
    assert tuple(cache["length"]) == ()


def test_rules_examples_of_the_reference():
    """tests/test_runtime.py's cases on the port's rules."""
    m = MESHES["16x16"]
    rules = shd.default_rules(m)
    assert tuple(shd.spec_for((64000, 4096), ("vocab", "embed"), m, rules)) == ("model", "data")
    assert tuple(shd.spec_for((576, 9, 64), ("embed", "heads", "head_dim"), m, rules))[1:] == (
        None, None)
    assert tuple(shd.spec_for((40, 1536, 512), ("experts", "embed", "mlp"), m, rules)) == (
        None, "data", "model")
    assert tuple(shd.spec_for((128, 7168, 4864), ("experts", "embed", "mlp"), m, rules)) == (
        "data", None, "model")
    pod = MESHES["pod"]
    assert tuple(shd.spec_for((128, 7168, 4864), ("experts", "embed", "mlp"), pod,
                              shd.default_rules(pod))) == (("pod", "data"), None, "model")
    cache = shd.cache_rules(m)
    assert tuple(shd.spec_for((128, 32768, 16, 64), ("batch", "seq", "kv_heads", "head_dim"), m,
                              cache)) == ("data", None, "model", None)
    assert tuple(shd.spec_for((128, 32768, 4, 64), ("batch", "seq", "kv_heads", "head_dim"), m,
                              cache)) == ("data", "model", None, None)


def test_batch_specs_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert tuple(shd.batch_spec(MESHES["pod"])) == tuple(jshd.batch_spec(MESHES["pod"]))
    assert tuple(shd.batch_spec(MESHES["2x2"])) == (("data",),)

    class Mesh:  # a DeviceMesh's names and shape
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 8)

    assert shd.placements(shd.PS(("pod", "data"), None, "model"), Mesh()) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.PS(None, None), Mesh()) == (Replicate(),) * 3
    assert shd.data_sharding(Mesh(), 3) == (Shard(0), Shard(0), Replicate())
    assert shd.axis_size(Mesh(), "model") == 8
    assert repr(shd.PS("data", None)) == "PartitionSpec('data', None)"


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_abstract_shapes_and_bytes_match_reference(name):
    jcfg, tcfg = JARCHS[name], get_arch(name)
    for key in SHAPES:
        jshape, tshape = JSHAPES[key], SHAPES[key]
        if tshape.kind == "decode":
            want = [tuple(a.shape) for a in _jleaves(jz.abstract_cache(jcfg, jshape))]
            got = [tuple(a.shape) for a in leaves(tz.abstract_cache(tcfg, tshape))]
            assert got == want
        m = 4 if tshape.kind == "train" else 1
        want = jz.input_specs(jcfg, jshape, num_microbatches=m)
        got = tz.input_specs(tcfg, tshape, num_microbatches=m)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert got[k].device.type == "meta"
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    for width in (2, 4):
        assert param_bytes(tz.model_spec(tcfg), width) == jbytes(jz.model_spec(jcfg), width)


# --------------------------------------------------------------------------
# K2's log-sum-exp output, on the CPU
# --------------------------------------------------------------------------
def _decode_case(b=3, h=8, kvh=2, s=40, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    return q, k, v


def test_decode_attention_plain_log_sum_exp_matches_float64():
    q, k, v = _decode_case()
    length = np.array([40, 17, 1], np.int32)
    out, lse = decode_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                      torch.from_numpy(length), return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (3, 8)
    qg = q.reshape(3, 2, 4, 16).astype(np.float64)
    logits = np.einsum("bkgd,bskd->bkgs", qg, k.astype(np.float64)) / math.sqrt(16)
    for i, n in enumerate(length):
        row = logits[i, ..., :n]
        top = row.max(-1, keepdims=True)
        want = (top[..., 0] + np.log(np.exp(row - top).sum(-1))).reshape(8)
        np.testing.assert_allclose(lse[i].numpy(), want, rtol=1e-6, atol=1e-6)
    plain = decode_attention_plain(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(length))
    assert torch.equal(out, plain)  # the output is unchanged by the flag


def _merge(parts):
    """The mesh's merge (models.layers._decode_on_mesh) on a list of
    (out, lse) shards."""
    lse = torch.stack([p[1] for p in parts])
    top = lse.max(dim=0).values
    w = torch.exp(lse - top)[..., None]
    num = sum(wi * p[0] for wi, p in zip(w, parts))
    return num / w.sum(dim=0)


@pytest.mark.parametrize("length", [40, 25, 20, 7])
def test_two_halves_merged_by_log_sum_exp_equal_the_whole(length):
    """A 40-row cache split in two 20-row halves, each with its own valid
    count clamp(length - r 20, 0, 20): the halves' outputs merged by their
    log-sum-exps equal K2 on the whole.  At length <= 20 the second half is
    empty: its lse is -inf, it adds nothing, and no NaN appears."""
    q, k, v = map(torch.from_numpy, _decode_case(seed=length))
    n = torch.full((3,), length, dtype=torch.int32)
    whole = decode_attention_plain(q, k, v, n)
    parts = []
    for r in range(2):
        valid = torch.clamp(n - 20 * r, 0, 20)
        parts.append(decode_attention_plain(q, k[:, 20 * r:20 * (r + 1)], v[:, 20 * r:20 * (r + 1)],
                                            valid, return_lse=True))
    if length <= 20:
        assert bool(torch.isneginf(parts[1][1]).all()) and not bool(parts[1][0].any())
    got = _merge(parts)
    assert not bool(torch.isnan(got).any())
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# the world and the reference's sharded run
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' results, their failed cases, the reference's results)."""
    d = tmp_path_factory.mktemp("model_sharding")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_model_sharding_world.py"),
                            str(d)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        world.run_world(d)
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(world.WORLD)]
    errors = [json.loads((d / f"rank{r}.json").read_text()) for r in range(world.WORLD)]
    return ranks, errors, dict(np.load(d / "reference.npz"))


def case(run, name, rank=0):
    """{key: array} of one case on one rank, failing with the rank's
    traceback if the case raised there."""
    ranks, errors, _ = run
    for r, e in enumerate(errors):
        assert name not in e, f"rank {r}: {e[name]}"
    prefix = f"{name}/"
    return {k[len(prefix):]: v for k, v in ranks[rank].items() if k.startswith(prefix)}


def reference(run, key):
    return run[2][key]


def test_every_rank_gets_the_same_whole_results(run):
    """The gathered logits and losses are the same on every rank."""
    first = case(run, "forward")
    for r in range(1, world.WORLD):
        got = case(run, "forward", r)
        for key in first:
            np.testing.assert_array_equal(got[key], first[key], err_msg=key)
    for r in range(1, world.WORLD):
        for name in world.TRAIN:
            np.testing.assert_array_equal(case(run, "train", r)[f"{name}/sharded"],
                                          case(run, "train")[f"{name}/sharded"])


@pytest.mark.parametrize("name", world.FORWARD)
def test_sharded_forward_matches_unsharded_and_reference(name, run):
    """forward_train on (2, 2), parameters placed by the default rules (FSDP
    on): the logits come out batch over data and vocab over model, and equal
    the port's unsharded logits and the reference's sharded ones."""
    got = case(run, "forward")
    assert str(got[f"{name}/placements"]) == "(Shard(dim=0), Shard(dim=2))"
    np.testing.assert_allclose(got[f"{name}/sharded"], got[f"{name}/plain"], **MODEL_TOL)
    np.testing.assert_allclose(got[f"{name}/sharded"], reference(run, f"forward/{name}"),
                               **MODEL_TOL)


def test_moe_takes_expert_parallelism_on_2x2_and_tensor_parallelism_on_1x4(run):
    """granite (4 experts): on (2, 2) the experts divide the data axis (EP:
    two all-to-alls over data, d_ff over model), on (1, 4) they do not (TP:
    d_ff over the 4 model shards); each path is taken once a MoE layer (2
    layers), and (1, 4)'s logits equal the reference's and the unsharded
    ones."""
    got = case(run, "moe")
    assert str(got["path22"]) == "ep" and str(got["path14"]) == "tp"
    assert list(got["calls_tp14"]) == [0, 2] and list(got["calls_ep22"]) == [2, 2]
    np.testing.assert_allclose(got["tp14"], reference(run, "moe/tp14"), **MODEL_TOL)
    np.testing.assert_allclose(got["tp14"], case(run, "forward")[f"{world.MOE}/plain"], **MODEL_TOL)
    np.testing.assert_allclose(got["ep22"], case(run, "forward")[f"{world.MOE}/sharded"], **MODEL_TOL)


@pytest.mark.parametrize("name", world.FORWARD)
def test_mesh_options_keep_the_logits(name, run):
    """seq_shard_attention, seq_parallel and fuse_projections all on."""
    got = case(run, "options")[f"{name}/options"]
    np.testing.assert_allclose(got, case(run, "forward")[f"{name}/plain"], **MODEL_TOL)
    np.testing.assert_allclose(got, reference(run, f"options/{name}"), **MODEL_TOL)


@pytest.mark.parametrize("name", world.DECODE)
def test_prefill_and_decode_on_a_sharded_cache(name, run):
    """Prefill 8 tokens, then 3 decode steps, the cache placed by the cache
    rules on (2, 2): one KV head cannot split, so the attention caches take
    the seq fallback (each model shard 8 of the 16 rows; K2 on each shard,
    merged by log-sum-exp; recurrentgemma's window-8 ring is split 4 and 4
    and wraps), tinyllama-kv2's 2 KV heads split over model.  The logits
    equal the unsharded and the reference's, the caches the unsharded."""
    got = case(run, "decode")
    np.testing.assert_allclose(got[f"{name}/sharded"], got[f"{name}/plain"], **MODEL_TOL)
    np.testing.assert_allclose(got[f"{name}/sharded"], reference(run, f"decode/{name}"), **MODEL_TOL)
    assert float(got[f"{name}/cache_err"]) <= 1e-5
    placements = str(got[f"{name}/cache_placements"])
    if name == "tinyllama-1.1b":  # (layers, B, S, KVH, hd): seq over model
        assert placements == "(Shard(dim=1), Shard(dim=2))"
    if name == "tinyllama-kv2":  # KV heads over model
        assert placements == "(Shard(dim=1), Shard(dim=3))"


@pytest.mark.parametrize("tag", ["ep", "tp", "rg"])
def test_sharded_gradients_match_unsharded(tag, run):
    """One microbatch's loss and gradients on the mesh: the MoE's EP path on
    (2, 2) and TP path on (1, 4) at a capacity that drops nothing, and the
    hybrid through K3's local_map on (2, 2)."""
    got = case(run, "grads")
    loss = got[f"{tag}/loss"]
    np.testing.assert_allclose(loss[1], loss[0], rtol=LOSS_RTOL)
    assert float(got[f"{tag}/grad_err"]) <= GRAD_REL


@pytest.mark.parametrize("name", world.TRAIN)
def test_sharded_trainer_matches_unsharded_and_reference(name, run):
    """3 steps of Trainer(mesh_info=MeshInfo((2, 2))) from the same weights:
    the losses of the port's unsharded trainer and of the reference's
    sharded one."""
    got = case(run, "train")
    np.testing.assert_allclose(got[f"{name}/sharded"], got[f"{name}/plain"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[f"{name}/sharded"], reference(run, f"train/{name}"),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", world.TRAIN)
def test_checkpoint_moves_between_sharded_and_unsharded_trainers(name, run):
    """The sharded trainer's checkpoint restores into an unsharded trainer
    bitwise, and the unsharded one's into a sharded trainer (its leaves
    replicated DTensors again), which then trains on as its source does."""
    got = case(run, "train")
    assert bool(got[f"{name}/restored_unsharded"]) and bool(got[f"{name}/to_unsharded_equal"])
    assert bool(got[f"{name}/restored_sharded"]) and bool(got[f"{name}/to_sharded_equal"])
    assert list(got[f"{name}/to_sharded_placements"]) == ["(Replicate(), Replicate())"]
    resumed, source = got[f"{name}/resumed"]
    np.testing.assert_allclose(resumed, source, rtol=LOSS_RTOL)


@pytest.mark.parametrize("kind", world.COMPRESS)
def test_a_compressing_trainer_on_a_mesh_trains_as_the_unsharded_one(kind, run):
    """3 steps of Trainer(mesh_info=MeshInfo((2, 2))) with gradient
    compression on 4 ranks: each replicated gradient is compressed whole,
    so the losses are the unsharded compressed trainer's, the same on every
    rank."""
    got = case(run, "compress")
    np.testing.assert_allclose(got[f"{kind}/sharded"], got[f"{kind}/plain"], rtol=LOSS_RTOL)
    for r in range(1, world.WORLD):
        np.testing.assert_array_equal(case(run, "compress", r)[f"{kind}/sharded"],
                                      got[f"{kind}/sharded"])


def test_kernel_wrappers_refuse_a_dtensor(run):
    got = case(run, "refusals")
    for name in ("decode_attention", "lru_scan"):
        assert str(got[name]).startswith(f"TypeError: {name} was handed a DTensor")


@pytest.mark.parametrize("mesh", ["22", "14"])
def test_xlstm_trains_on_a_mesh_as_the_unsharded_one(mesh, run):
    """Fault 3i: a training microbatch of reduced xlstm (4 heads; 7 mLSTM
    layers and an sLSTM layer) on (2, 2), where the heads split 2 and 2,
    and on (1, 4), one head a shard: the mLSTM's and sLSTM's projections
    and the sLSTM's loop run shard by shard, log sigmoid on each shard.  The
    loss and every gradient within 1e-5 of the unsharded twin's."""
    got = case(run, "xlstm")
    loss = got[f"{mesh}/loss"]
    np.testing.assert_allclose(loss[1], loss[0], rtol=1e-5)
    assert float(got[f"{mesh}/grad_err"]) <= 1e-5


def test_a_vocab_split_lookup_is_bitwise_the_whole_tables(run):
    """Fault 3j: the embedding from a table whose vocab the model axis of
    (1, 4) splits (the serving layout) is the masked lookup summed by one
    all-reduce: bitwise the unsharded lookup, and so is the table's
    gradient."""
    got = case(run, "lookup")
    assert str(got["table_placements"]) == "(Replicate(), Shard(dim=0))"
    np.testing.assert_array_equal(got["sharded/x"], got["plain/x"])
    np.testing.assert_array_equal(got["sharded/grad"], got["plain/grad"])
