"""The worlds behind tests/test_torch_model_sharding.py.

``run_world(directory)`` spawns a world of 4 gloo ranks on the CPU (a
``FileStore`` in ``directory``, torch on one thread a rank).  Each rank runs
every case of ``CASES`` through the port's model stack on a (2, 2) or (1, 4)
("data", "model") ``DeviceMesh`` and, beside it, unsharded; it writes what it
got to ``directory/rank{r}.npz`` (a failed case's traceback to
``rank{r}.json``).

``python tests/torch_model_sharding_world.py DIRECTORY`` runs the reference's
sharded calls on the same inputs in a JAX process of 4 host devices and
writes ``DIRECTORY/reference.npz``.  Weights and inputs are numpy draws from
fixed seeds, made by the functions below, which both sides call.
"""
from __future__ import annotations

import json
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

WORLD = 4
# "tinyllama-kv2" is reduced tinyllama with 2 KV heads: they split over the
# model axis, where every other reduced config's one KV head cannot
FORWARD = ("tinyllama-1.1b", "recurrentgemma-2b", "xlstm-1.3b", "whisper-medium",
           "granite-moe-3b-a800m", "tinyllama-kv2")
DECODE = ("tinyllama-1.1b", "recurrentgemma-2b", "xlstm-1.3b", "tinyllama-kv2")
TRAIN = ("granite-moe-3b-a800m", "recurrentgemma-2b")
COMPRESS = ("int8_ef", "topk_ef")  # the trainer's gradient compression, on reduced tinyllama
MOE = "granite-moe-3b-a800m"
B, T = 4, 16  # the batch divides the data axis; the sequence the model axis
PROMPT, STEPS, MAX_LEN = 8, 3, 16
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB = 3, 8, 32, 2
OPTIONS = dict(seq_shard_attention=True, seq_parallel=True, fuse_projections=True)
BIAS_SCALE = 0.1  # the standard deviation of drawn biases (tests/test_torch_models.py)


# --------------------------------------------------------------------------
# weights and inputs, from numpy seeds (both packages)
# --------------------------------------------------------------------------
def draw(tree_map, spec, draw_biases, seed=0):
    """Numpy leaves along a spec, in the order ``tree_map`` visits them (both
    packages visit dict keys sorted): normal(0, scale), ones and zeros as the
    packages initialise them, the biases drawn with ``draw_biases``."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        if p.init == "ones" or (p.init == "zeros" and not draw_biases):
            return np.full(p.shape, float(p.init == "ones"), np.float32)
        scale = BIAS_SCALE if p.init == "zeros" else p.scale
        return (scale * rng.normal(size=p.shape)).astype(np.float32)

    return tree_map(leaf, spec)


def config(reduced, registry, name):
    """``name``'s reduced config (recurrentgemma's window of 8 makes its
    16-row cache a ring of 8 slots)."""
    if name == "tinyllama-kv2":
        return reduced(registry("tinyllama-1.1b"), num_kv_heads=2)
    return reduced(registry(name))


def inputs(cfg, b=B, t=T, seed=0):
    """Tokens and the family's frames (an encoder-decoder's) as numpy draws."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def train_run(run_config, shape_config, cfg, directory, **kw):
    """The trainer's run: 8 x 32 tokens in 2 microbatches, no partitioner;
    ``kw`` sets other fields (the gradient compression)."""
    return run_config(model=cfg, shape=shape_config("t", TRAIN_SEQ, TRAIN_BATCH, "train"),
                      learning_rate=1e-3, warmup_steps=1, total_steps=10, remat="none",
                      partitioner_enabled=False, checkpoint_every=10**6,
                      checkpoint_dir=str(directory), **kw)


# --------------------------------------------------------------------------
# the torch ranks
# --------------------------------------------------------------------------
def _port(name):
    """(config, numpy weights, plain params) of a reduced arch."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model_zoo, params

    cfg = config(reduced, get_arch, name)
    tree = draw(params.tree_map, model_zoo.model_spec(cfg), cfg.use_bias)
    return cfg, tree, params.tree_map(torch.from_numpy, tree)


def _mesh_info(shape):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import MeshInfo

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    return MeshInfo(mesh, ("data",), "model")


def _placed(cfg, params, mi):
    """``params`` as DTensors placed by the default rules (FSDP on)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model_zoo

    specs = sharding.tree_shardings(model_zoo.abstract_model_params(cfg),
                                    model_zoo.model_axes(cfg), mi.mesh,
                                    sharding.default_rules(mi.mesh))
    return sharding.shard_tree(params, specs, mi.mesh)


def _batch(cfg, **kw):
    import torch

    return {k: torch.from_numpy(v) for k, v in inputs(cfg, **kw).items()}


def _np(x):
    from repro_torch.device import is_dtensor

    return (x.full_tensor() if is_dtensor(x) else x).detach().numpy()


def _forward(name, mi, **options):
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx

    cfg, _, params = _port(name)
    batch = _batch(cfg)
    ctx = ApplyCtx(mode="train", mesh_info=mi, **options)
    return model_zoo.forward_train(cfg, _placed(cfg, params, mi), batch, ctx=ctx)[0]


def case_forward(mi22, mi14):
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx

    out = {}
    for name in FORWARD:
        cfg, _, params = _port(name)
        out[f"{name}/plain"] = _np(model_zoo.forward_train(cfg, params, _batch(cfg),
                                                           ctx=ApplyCtx(mode="train"))[0])
        logits = _forward(name, mi22)
        out[f"{name}/sharded"] = _np(logits)
        out[f"{name}/placements"] = np.array(str(logits.placements))
    return out


def case_moe(mi22, mi14):
    """The MoE's two sharded paths, each counted: (2, 2) takes expert
    parallelism (4 experts over 2 data shards), (1, 4) tensor parallelism."""
    from repro_torch.models import moe

    calls = {"ep": 0, "tp": 0}
    ep, tp = moe._moe_ep_shard, moe._moe_tp_shard

    def count(path, fn):
        def wrapped(*a, **kw):
            calls[path] += 1
            return fn(*a, **kw)
        return wrapped

    moe._moe_ep_shard, moe._moe_tp_shard = count("ep", ep), count("tp", tp)
    try:
        cfg = _port(MOE)[0]
        out = {"path22": np.array(moe.moe_path(cfg, mi22)), "path14": np.array(moe.moe_path(cfg, mi14))}
        out["tp14"] = _np(_forward(MOE, mi14))
        out["calls_tp14"] = np.array([calls["ep"], calls["tp"]])
        out["ep22"] = _np(_forward(MOE, mi22))
        out["calls_ep22"] = np.array([calls["ep"], calls["tp"]])
    finally:
        moe._moe_ep_shard, moe._moe_tp_shard = ep, tp
    return out


def case_options(mi22, mi14):
    return {f"{name}/options": _np(_forward(name, mi22, **OPTIONS)) for name in FORWARD}


def _serve(cfg, params, mi):
    """Prefill PROMPT tokens into a MAX_LEN cache, then STEPS teacher-forced
    decode steps of the drawn tokens; the logits of each, and the cache."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx

    tokens = _batch(cfg)["tokens"]
    cache = model_zoo.init_cache(cfg, B, MAX_LEN, torch.float32, device="cpu")
    if mi is not None:
        params = _placed(cfg, params, mi)
        axes = model_zoo.transformer.cache_axes_tree(cfg)
        specs = sharding.cache_shardings(cache, axes, mi.mesh)
        cache = sharding.shard_tree(cache, specs, mi.mesh)
    logits, cache = model_zoo.prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, cache,
                                      ctx=ApplyCtx(mode="prefill", mesh_info=mi))
    got = [_np(logits)]
    for j in range(PROMPT, PROMPT + STEPS):
        logits, cache = model_zoo.decode_step(cfg, params, tokens[:, j:j + 1], cache,
                                              ctx=ApplyCtx(mode="decode", mesh_info=mi))
        got.append(_np(logits))
    return np.stack(got), cache


def case_decode(mi22, mi14):
    from repro_torch.distributed import sharding
    from repro_torch.models.params import leaves

    out = {}
    for name in DECODE:
        cfg, _, params = _port(name)
        out[f"{name}/plain"], plain_cache = _serve(cfg, params, None)
        out[f"{name}/sharded"], cache = _serve(cfg, params, mi22)
        out[f"{name}/cache_err"] = np.array(max(
            float(np.abs(a - _np(b)).max()) for a, b in zip(
                [_np(x) for x in leaves(plain_cache)], leaves(sharding.gather_tree(cache)))))
        k = leaves(cache["cycles"])[0]
        out[f"{name}/cache_placements"] = np.array(str(k.placements))
    return out


def case_grads(mi22, mi14):
    """One microbatch's gradients on the mesh against the unsharded ones: the
    MoE on both of its paths, at a capacity that drops nothing (then the
    ranks' local capacities change no token), and the hybrid through K3's
    local_map.  Each sharded gradient is gathered whole."""
    import dataclasses

    import torch

    from repro_torch.models.layers import ApplyCtx
    from repro_torch.models.params import leaves
    from repro_torch.train import train_step

    out = {}
    for name, mi, tag in ((MOE, mi22, "ep"), (MOE, mi14, "tp"), ("recurrentgemma-2b", mi22, "rg")):
        cfg, _, params = _port(name)
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        rng = np.random.default_rng(5)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        (loss, _), plain = train_step.microbatch_value_and_grad(cfg, ApplyCtx(mode="train"))(
            params, batch)
        (mloss, _), grads = train_step.microbatch_value_and_grad(
            cfg, ApplyCtx(mode="train", mesh_info=mi))(_placed(cfg, params, mi), batch)
        out[f"{tag}/loss"] = np.array([float(loss), float(mloss)])
        out[f"{tag}/grad_err"] = np.array(max(
            float(np.abs(_np(g) - _np(p)).max() / max(np.abs(_np(p)).max(), 1e-12))
            for g, p in zip(leaves(grads), leaves(plain))))
    return out


def case_xlstm(mi22, mi14):
    """Fault 3i: one training microbatch of reduced xlstm (7 mLSTM and 1
    sLSTM layer, 4 heads) on (2, 2) (the heads split 2 and 2) and (1, 4)
    (one head a shard) against the unsharded one: the loss, and each
    gathered gradient's largest error relative to its leaf's largest
    magnitude."""
    import torch

    from repro_torch.models.layers import ApplyCtx
    from repro_torch.models.params import leaves
    from repro_torch.train import train_step

    cfg, _, params = _port("xlstm-1.3b")
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32))
             for k in ("tokens", "labels")}
    (loss, _), plain = train_step.microbatch_value_and_grad(cfg, ApplyCtx(mode="train"))(
        params, batch)
    out = {}
    for tag, mi in (("22", mi22), ("14", mi14)):
        (mloss, _), grads = train_step.microbatch_value_and_grad(
            cfg, ApplyCtx(mode="train", mesh_info=mi))(_placed(cfg, params, mi), batch)
        out[f"{tag}/loss"] = np.array([float(loss), float(mloss)])
        out[f"{tag}/grad_err"] = np.array(max(
            float(np.abs(_np(g) - _np(p)).max() / max(np.abs(_np(p)).max(), 1e-12))
            for g, p in zip(leaves(grads), leaves(plain))))
    return out


def case_lookup(mi22, mi14):
    """Fault 3j: the embedding of the drawn tokens from a table in the serving
    layout (``default_rules(fsdp=False)``: the vocab over model, the rows
    whole) on (1, 4), and the table's gradient of a drawn weighting of it,
    each gathered whole, beside the unsharded ones."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.models import transformer
    from repro_torch.models.layers import ApplyCtx, mesh_scope

    cfg, _, params = _port("tinyllama-1.1b")
    tokens = _batch(cfg)["tokens"]
    weight = torch.from_numpy(np.random.default_rng(9).normal(
        size=(B, T, cfg.d_model)).astype(np.float32))
    specs = sharding.tree_shardings({"embed": params["embed"]},
                                    {"embed": transformer.lm_spec(cfg)["embed"].axes}, mi14.mesh,
                                    sharding.default_rules(mi14.mesh, fsdp=False))
    out = {}
    for tag, mi in (("plain", None), ("sharded", mi14)):
        emb = params["embed"].detach().clone()
        if mi is not None:
            emb = sharding.shard_tree({"embed": emb}, specs, mi.mesh)["embed"]
        emb.requires_grad_(True)
        ctx = ApplyCtx(mode="train", mesh_info=mi)
        with mesh_scope(ctx):
            x = transformer._embed(cfg, {"embed": emb}, tokens, None, ctx)
            (grad,) = torch.autograd.grad((x * weight).sum(), [emb])
        out[f"{tag}/x"], out[f"{tag}/grad"] = _np(x), _np(grad)
        if mi is not None:
            out["table_placements"] = np.array(str(emb.placements))
    return out


def _trainer(name, mi, directory, **kw):
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.distributed.sharding import replicated_specs, shard_tree
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer

    cfg, _, params = _port(name)
    tr = Trainer(train_run(RunConfig, ShapeConfig, cfg, directory, **kw), mesh_info=mi,
                 num_microbatches=TRAIN_MB, device="cpu")
    state = adamw.init(params)  # the drawn weights, both packages
    if mi is not None:
        rep = lambda tree: shard_tree(tree, replicated_specs(tree), mi.mesh)
        params, state = rep(params), adamw.AdamWState(*(rep(x) for x in state))
    tr.params, tr.opt_state = params, state
    return tr


def case_train(mi22, mi14, directory, rank):
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.models.params import leaves

    out = {}
    base = Path(directory) / f"ckpt{rank}"
    for name in TRAIN:
        sharded = _trainer(name, mi22, base / name / "sharded")
        out[f"{name}/sharded"] = np.array(sharded.train(TRAIN_STEPS).losses)
        plain = _trainer(name, None, base / name / "plain")
        out[f"{name}/plain"] = np.array(plain.train(TRAIN_STEPS).losses)
        # sharded -> unsharded: the saved leaves whole, bitwise
        sharded.save()
        sharded.ckpt.wait()
        restored = _trainer(name, None, base / name / "sharded")
        out[f"{name}/restored_unsharded"] = np.array(restored.try_restore())
        want = [_np(x) for x in leaves(gather_tree(sharded.params))]
        out[f"{name}/to_unsharded_equal"] = np.array(all(
            np.array_equal(a, _np(b)) for a, b in zip(want, leaves(restored.params))))
        # unsharded -> sharded, placements kept
        plain.save()
        plain.ckpt.wait()
        back = _trainer(name, mi22, base / name / "plain")
        out[f"{name}/restored_sharded"] = np.array(back.try_restore())
        got = leaves(back.params)
        out[f"{name}/to_sharded_equal"] = np.array(all(
            np.array_equal(_np(a), _np(b)) for a, b in zip(got, leaves(plain.params))))
        out[f"{name}/to_sharded_placements"] = np.array(sorted({str(x.placements) for x in got}))
        # and the restored runs go on as their source would
        out[f"{name}/resumed"] = np.array(back.train(1).losses + plain.train(1).losses)
    return out


def case_compress(mi22, mi14, directory, rank):
    """The trainer with each gradient compression on (2, 2) and unsharded,
    from the same weights: the losses of each."""
    out = {}
    base = Path(directory) / f"compress{rank}"
    for kind in COMPRESS:
        for tag, mi in (("sharded", mi22), ("plain", None)):
            tr = _trainer("tinyllama-1.1b", mi, base / kind / tag, grad_compression=kind)
            out[f"{kind}/{tag}"] = np.array(tr.train(TRAIN_STEPS).losses)
    return out


def case_refusals(mi22, mi14):
    """A kernel wrapper handed a DTensor raises and names it."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops

    def error(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the test reads the type and message
            return np.array(f"{type(e).__name__}: {e}")
        return np.array("no error")

    d = lambda x: distribute_tensor(x, mi22.mesh, [Replicate(), Replicate()], src_data_rank=None)
    q, kv = torch.zeros(2, 4, 16), torch.zeros(2, 8, 1, 16)
    a = torch.full((2, 8, 4), 0.5)
    return {"decode_attention": error(lambda: ops.decode_attention(d(q), d(kv), d(kv))),
            "lru_scan": error(lambda: ops.lru_scan(d(a), d(a)))}


CASES = ("forward", "moe", "options", "decode", "grads", "train", "compress", "refusals", "xlstm",
         "lookup")


def rank_main(rank, world, directory):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(directory) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    results, errors = {}, {}
    try:
        mi22, mi14 = _mesh_info((2, 2)), _mesh_info((1, 4))
        for name in CASES:
            case = globals()[f"case_{name}"]
            try:
                got = (case(mi22, mi14, directory, rank) if name in ("train", "compress")
                       else case(mi22, mi14))
            except Exception:  # noqa: BLE001 — each test reads its own case's failure
                errors[name] = traceback.format_exc()
                continue
            results.update({f"{name}/{key}": value for key, value in got.items()})
    finally:
        np.savez(Path(directory) / f"rank{rank}.npz", **results)
        (Path(directory) / f"rank{rank}.json").write_text(json.dumps(errors))
        dist.destroy_process_group()


def run_world(directory, world=WORLD, timeout=240.0):
    """Spawn the ranks and wait for them; raise if one fails or they outlast
    ``timeout`` seconds."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(rank_main, args=(world, str(directory)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the gloo world did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()


# --------------------------------------------------------------------------
# the reference, in a JAX process of 4 host devices
# --------------------------------------------------------------------------
def reference_main(directory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.configs import ARCHS, reduced
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.distributed import sharding
    from repro.models import model_zoo, transformer
    from repro.models.layers import ApplyCtx, MeshInfo
    from repro.models.params import P
    from repro.optim import adamw
    from repro.train.trainer import Trainer

    devices = np.array(jax.devices())
    # jax.sharding.Mesh, not jax.make_mesh: the latter's axes are Explicit,
    # and with_sharding_constraint then raises
    meshes = {"22": Mesh(devices.reshape(2, 2), ("data", "model")),
              "14": Mesh(devices.reshape(1, 4), ("data", "model"))}
    mesh_info = lambda m: MeshInfo(meshes[m], ("data",), "model")
    tree_map = lambda fn, spec: jax.tree_util.tree_map(fn, spec, is_leaf=lambda x: isinstance(x, P))

    def model(name):
        cfg = config(reduced, ARCHS.__getitem__, name)
        return cfg, jax.tree_util.tree_map(jnp.asarray, draw(tree_map, model_zoo.model_spec(cfg),
                                                             cfg.use_bias))

    def placed(cfg, params, mesh):
        sh = sharding.tree_shardings(model_zoo.abstract_model_params(cfg),
                                     model_zoo.model_axes(cfg), mesh, sharding.default_rules(mesh))
        return jax.device_put(params, sh)

    def forward(name, m, **options):
        cfg, params = model(name)
        ctx = ApplyCtx(mode="train", mesh_info=mesh_info(m), **options)
        batch = {k: jnp.asarray(v) for k, v in inputs(cfg).items()}
        fn = jax.jit(lambda p, b: model_zoo.forward_train(cfg, p, b, ctx=ctx)[0])
        return np.asarray(fn(placed(cfg, params, meshes[m]), batch))

    out = {}
    for name in FORWARD:
        out[f"forward/{name}"] = forward(name, "22")
        out[f"options/{name}"] = forward(name, "22", **OPTIONS)
    out["moe/tp14"] = forward(MOE, "14")

    for name in DECODE:
        cfg, params = model(name)
        mesh = meshes["22"]
        params = placed(cfg, params, mesh)
        cache = model_zoo.init_cache(cfg, B, MAX_LEN, jnp.float32)
        cache = jax.device_put(cache, sharding.cache_shardings(
            cache, transformer.cache_axes_tree(cfg), mesh))
        tokens = jnp.asarray(inputs(cfg)["tokens"])
        pre = jax.jit(lambda p, b, c: model_zoo.prefill(
            cfg, p, b, c, ctx=ApplyCtx(mode="prefill", mesh_info=mesh_info("22"))))
        dec = jax.jit(lambda p, t, c: model_zoo.decode_step(
            cfg, p, t, c, ctx=ApplyCtx(mode="decode", mesh_info=mesh_info("22"))))
        logits, cache = pre(params, {"tokens": tokens[:, :PROMPT]}, cache)
        got = [np.asarray(logits)]
        for j in range(PROMPT, PROMPT + STEPS):
            logits, cache = dec(params, tokens[:, j:j + 1], cache)
            got.append(np.asarray(logits))
        out[f"decode/{name}"] = np.stack(got)

    for name in TRAIN:
        cfg, params = model(name)
        tr = Trainer(train_run(RunConfig, ShapeConfig, cfg, Path(directory) / "jax" / name),
                     num_microbatches=TRAIN_MB, mesh_info=mesh_info("22"))
        tr.params, tr.opt_state = params, adamw.init(params)
        out[f"train/{name}"] = np.array(tr.train(TRAIN_STEPS).losses)
    np.savez(Path(directory) / "reference.npz", **out)


if __name__ == "__main__":
    reference_main(sys.argv[1])
