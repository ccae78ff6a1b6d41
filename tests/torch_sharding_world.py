"""The worlds behind tests/test_torch_sharding.py.

``run_world(directory)`` spawns a world of gloo ranks on the CPU (a
``FileStore`` in ``directory``, torch on one thread a rank); each rank builds
``ShardingConfig.auto()``, runs every case of ``CASES`` through the port's
sharded paths and beside them the unsharded calls, and writes what it got to
``directory/rank{r}.npz`` (a failed case's traceback to ``rank{r}.json``).

``python tests/torch_sharding_world.py DIRECTORY`` runs the reference's
sharded calls on the same inputs in a JAX process of 8 host devices and
writes ``DIRECTORY/reference.npz``.  Inputs are drawn with numpy from fixed
seeds by the functions below, which both sides call.
"""
from __future__ import annotations

import json
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

WORLD = 4
K1_K, K1_N, K1_G = 5, 48, 64  # K not divisible by the shard count: the pad path
HIER_K = 5


# --------------------------------------------------------------------------
# inputs, from numpy seeds (both packages)
# --------------------------------------------------------------------------
def telemetry(k, n, seed):
    """t = f^0.9 25 + f^0.7 2 N(0, 1), f ~ U(0.05, 0.95), as the reference's
    tests/test_sharding.py draws its fleet."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.95, (k, n)).astype(np.float32)
    t = (f**0.9 * 25.0 + f**0.7 * 2.0 * rng.normal(size=(k, n))).astype(np.float32)
    return t, f


def k1_inputs():
    t, f = telemetry(K1_K, K1_N, seed=3)
    ones = np.ones((K1_K,), np.float32)
    grid = np.linspace(1e-4, 1.0 - 1e-4, K1_G).astype(np.float32)
    return dict(grid=grid, t=t, f=f, mu=25.0 * ones, lam=0.25 * ones, alpha=0.9 * ones,
                beta=0.7 * ones, pa=2.0 * ones, pb=2.0 * ones)


def hier_fleet():
    """A (K,) fleet's posterior leaves, two of its workers cold (nu0 = 1:
    effective sample size 0), so shrink moves them onto the pool."""
    rng = np.random.default_rng(21)
    k = HIER_K
    u = lambda lo, hi: rng.uniform(lo, hi, k).astype(np.float32)
    nu0 = u(2.0, 40.0)
    nu0[[1, 3]] = 1.0
    return dict(mu0=u(10.0, 40.0), kappa0=u(1.0, 50.0), nu0=nu0, psi0=u(0.5, 20.0),
                aa=u(1.0, 30.0), ab=u(1.0, 30.0), ba=u(1.0, 30.0), bb=u(1.0, 30.0),
                mu=u(10.0, 40.0), lam=u(0.05, 2.0), alpha=u(0.5, 0.95), beta=u(0.4, 0.9))


HIER_MASK = np.array([1.0, 1.0, 0.0, 1.0, 1.0], np.float32)


# --------------------------------------------------------------------------
# the torch ranks
# --------------------------------------------------------------------------
def flat(prefix, tree):
    """{prefix.field...: numpy} for a (nested) NamedTuple of tensors."""
    import torch

    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    if isinstance(tree, torch.Generator):
        return {prefix: tree.get_state().numpy()}
    out = {}
    for name in tree._fields:
        leaf = getattr(tree, name)
        if leaf is not None:
            out.update(flat(f"{prefix}.{name}", leaf))
    return out


def _generator(seed):
    import torch

    return torch.Generator().manual_seed(seed)


def _fork(gen):
    """A copy of ``gen``: the same stream from the same point."""
    import torch

    g = torch.Generator()
    g.set_state(gen.get_state())
    return g


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads the type and message
        return np.array(f"{type(e).__name__}: {e}")
    return np.array("no error")


def case_plumbing(cfg):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import sched
    from repro_torch.core.sharding import ShardingConfig

    other = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("model",))
    twin = ShardingConfig.auto()
    half = ShardingConfig.auto(num_devices=2)
    return {
        "bad_axis": _error(lambda: ShardingConfig(mesh=other)),
        "other_axis_shards": np.array(ShardingConfig(mesh=other, axis="model").num_shards),
        "num_shards": np.array(cfg.num_shards),
        "rank": np.array(cfg.rank),
        "pad10": np.array(cfg.pad(10)),
        "half_shards": np.array(half.num_shards),
        "equal": np.array(cfg == twin and hash(cfg) == hash(twin)),
        "config_equal": np.array(sched.SchedulerConfig(mesh=cfg) == sched.SchedulerConfig(mesh=twin)
                                 and hash(sched.SchedulerConfig(mesh=cfg))
                                 == hash(sched.SchedulerConfig(mesh=twin))),
        "bare_mesh_wrapped": np.array(sched.SchedulerConfig(mesh=cfg.mesh).mesh == cfg),
        "device_type": np.array(cfg.mesh.device_type),
    }


def case_k1(cfg):
    import torch
    from repro_torch.core.moments import BetaParams
    from repro_torch.kernels import ops

    x = {k: torch.from_numpy(v) for k, v in k1_inputs().items()}
    prior = BetaParams(x["pa"], x["pb"])
    args = (x["grid"], x["t"], x["f"], x["mu"], x["lam"], x["alpha"], x["beta"], prior, prior)
    return {
        "sharded": ops.posterior_grid_fleet(*args, sharding=cfg).numpy(),
        "unsharded": ops.posterior_grid_fleet(*args).numpy(),
        "active_idx": _error(lambda: ops.posterior_grid_fleet(
            *args, sharding=cfg, active_idx=torch.arange(K1_K))),
    }


def _fleet_state(k, seed):
    from repro_torch.core import gibbs

    return gibbs.init_state(_generator(seed), mu_guess=25.0, shape=(k,))


def case_gibbs(cfg):
    import torch
    from repro_torch.core import gibbs

    out = {}
    kw = dict(n_iters=3, grid_size=64)
    for k in (8, 6):  # divisible by the 4 shards, and not (2 pad rows)
        state = _fleet_state(k, seed=k)
        t, f = map(torch.from_numpy, telemetry(k, 64, seed=k))
        gen = _generator(100 + k)
        g0, g1 = _fork(gen), _fork(gen)
        st0, ll0 = gibbs.gibbs_batch(state, t, f, generator=g0, **kw)
        st1, ll1 = gibbs.gibbs_batch(state, t, f, generator=g1, sharding=cfg, **kw)
        out.update(flat(f"k{k}.unsharded", st0), **flat(f"k{k}.sharded", st1))
        out.update({f"k{k}.unsharded.ll": ll0.numpy(), f"k{k}.sharded.ll": ll1.numpy(),
                    f"k{k}.unsharded.gen": g0.get_state().numpy(),
                    f"k{k}.sharded.gen": g1.get_state().numpy()})
        # a masked batch: the mask path with the pad rows' zeros beside it
        mask = (torch.arange(64)[None, :] < torch.arange(40, 40 + 3 * k, 3)[:, None]).float()
        st0, ll0 = gibbs.gibbs_batch(state, t, f, mask, generator=_fork(gen), **kw)
        st1, ll1 = gibbs.gibbs_batch(state, t, f, mask, generator=_fork(gen), sharding=cfg, **kw)
        out.update({f"k{k}.masked.unsharded.ll": ll0.numpy(), f"k{k}.masked.sharded.ll": ll1.numpy(),
                    f"k{k}.masked.unsharded.alpha": st0.alpha.numpy(),
                    f"k{k}.masked.sharded.alpha": st1.alpha.numpy()})

    # identical workers with identical telemetry: shards must not share noise
    k = 8
    one = _fleet_state(1, seed=5)
    same = gibbs.tree_map(lambda x: x.expand(k).clone(), one)
    t, f = map(torch.from_numpy, telemetry(1, 64, seed=5))
    st, _ = gibbs.gibbs_batch(same, t.expand(k, 64).clone(), f.expand(k, 64).clone(),
                              generator=_generator(7), sharding=cfg, **kw)
    out.update(flat("identical", st))

    state = _fleet_state(8, seed=8)
    t, f = map(torch.from_numpy, telemetry(8, 64, seed=8))
    out["active_idx"] = _error(lambda: gibbs.gibbs_batch(
        state, t, f, generator=_generator(0), sharding=cfg, active_idx=torch.arange(8), **kw))
    meta = gibbs.tree_map(lambda x: x.to("meta"), state)
    out["off_mesh_device"] = _error(lambda: gibbs.gibbs_batch(
        meta, t.to("meta"), f.to("meta"), generator=_generator(0), sharding=cfg, **kw))
    return out


def case_fit_dag(cfg):
    from repro_torch.core import gibbs

    t, f = telemetry(12, 48, seed=12)
    t, f = t.reshape(3, 4, 48), f.reshape(3, 4, 48)
    kw = dict(n_iters=2, grid_size=64, device="cpu")
    st0, ll0 = gibbs.fit_dag(7, t, f, **kw)
    st1, ll1 = gibbs.fit_dag(7, t, f, sharding=cfg, **kw)
    return {**flat("unsharded", st0), **flat("sharded", st1),
            "unsharded.ll": ll0.numpy(), "sharded.ll": ll1.numpy()}


def hier_state():
    """``hier_fleet`` as the port's GibbsState."""
    import torch
    from repro_torch.core.gibbs import GibbsState
    from repro_torch.core.moments import BetaParams
    from repro_torch.core.posterior import NormalGammaParams

    x = {k: torch.from_numpy(v) for k, v in hier_fleet().items()}
    return GibbsState(NormalGammaParams(x["mu0"], x["kappa0"], x["nu0"], x["psi0"]),
                      BetaParams(x["aa"], x["ab"]), BetaParams(x["ba"], x["bb"]),
                      x["mu"], x["lam"], x["alpha"], x["beta"])


def case_hier(cfg):
    import torch
    from repro_torch import hier

    fleet = hier_state()
    mask = torch.from_numpy(HIER_MASK)
    h0 = hier.fit_hyperprior(fleet)
    out = {**flat("fit.unsharded", h0), **flat("fit.sharded", hier.fit_hyperprior_sharded(fleet, cfg)),
           **flat("fit_masked.unsharded", hier.fit_hyperprior(fleet, mask)),
           **flat("fit_masked.sharded", hier.fit_hyperprior_sharded(fleet, cfg, mask)),
           **flat("shrink.unsharded", hier.shrink(fleet, h0)),
           **flat("shrink.sharded", hier.shrink(fleet, h0, sharding=cfg)),
           "surprise.unsharded": hier.surprise(fleet, h0).numpy(),
           "surprise.sharded": hier.surprise(fleet, h0, sharding=cfg).numpy()}
    return out


SCHED = dict(n_iters=2, grid_size=32, num_points=64, opt_steps=20)


def _pair(cfg, **over):
    from repro_torch import sched

    return (sched.SchedulerConfig(**SCHED, **over),
            sched.SchedulerConfig(**SCHED, **over, mesh=cfg))


def _telem(k, n, seed):
    import torch
    from repro_torch import sched

    t, f = telemetry(k, n, seed)
    return sched.Telemetry(fracs=torch.from_numpy(f), times=torch.from_numpy(t))


def case_sched(cfg):
    from repro_torch import sched

    out = {}
    for k in (8, 6):
        plain, meshed = _pair(cfg, mu_guess=25.0)
        for tag, c in (("unsharded", plain), ("sharded", meshed)):
            st = sched.init(c, k, seed=1, device="cpu")
            st, ll = sched.observe(st, _telem(k, 32, seed=40 + k), c)
            fr, stats = sched.propose(st, c)
            out.update(flat(f"k{k}.{tag}", st.gibbs))
            out.update({f"k{k}.{tag}.ll": ll.numpy(), f"k{k}.{tag}.fracs": fr.numpy(),
                        f"k{k}.{tag}.e_t": stats.e_t.numpy(),
                        f"k{k}.{tag}.gen": st.generator.get_state().numpy()})

    dag = sched.WorkflowDAG.chain(3, 4)
    plain, meshed = _pair(cfg, mu_guess=25.0)
    t, f = telemetry(12, 32, seed=50)
    tel = sched.Telemetry(fracs=_t(f.reshape(3, 4, 32)), times=_t(t.reshape(3, 4, 32)))
    for tag, c in (("unsharded", plain), ("sharded", meshed)):
        d = sched.init_dag(c, dag, seed=2, device="cpu")
        d, ll = sched.observe_dag(d, tel, c)
        out.update(flat(f"dag.{tag}", d.gibbs))
        out.update({f"dag.{tag}.ll": ll.numpy(), f"dag.{tag}.gen": d.generator.get_state().numpy()})

    # fault 3f: every slot of a capacity state live, one batch of N = 16
    for tag, capacity in (("capacity", 8), ("exact", None)):
        st = sched.init(meshed, 8, seed=6, device="cpu", capacity=capacity)
        st, _ = sched.observe(st, _telem(8, 16, seed=63), meshed)
        out[f"nu.{tag}"] = st.gibbs.ng.nu0.numpy()

    plain, meshed = _pair(cfg, mu_guess=25.0, hierarchical=True)
    for tag, c in (("unsharded", plain), ("sharded", meshed)):
        # admission into dead slots of a capacity state: the refit masks them
        st = sched.init(c, 5, seed=3, device="cpu", capacity=8)
        st, _ = sched.observe(st, _telem(8, 32, seed=60), c)
        st = sched.admit_workers(st, 2, c)
        out.update(flat(f"admit.{tag}", st.gibbs))
        out.update({f"admit.{tag}.live": st.live.numpy(),
                    f"admit.{tag}.gen": st.generator.get_state().numpy()})
        # up-scale of an exact-size fleet
        st = sched.init(c, 6, seed=4, device="cpu")
        st, _ = sched.observe(st, _telem(6, 32, seed=61), c)
        st = sched.add_workers(st, 2, c)
        out.update(flat(f"add.{tag}", st.gibbs))
        out[f"add.{tag}.gen"] = st.generator.get_state().numpy()
        # the imperative shell's pooling
        s = sched.Scheduler(6, config=c, seed=5, device="cpu")
        s.observe(_telem(6, 32, seed=62))
        out.update(flat(f"shell.{tag}.hyper", s.fit_hyperprior()))
        out[f"shell.{tag}.surprise"] = s.surprise()
        s.shrink()
        out.update(flat(f"shell.{tag}.shrunk", s.state.gibbs))
    return out


def _t(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x))


def case_checkpoint(cfg, directory, rank):
    from repro_torch import sched
    from repro_torch.checkpoint.checkpoint import CheckpointManager

    _, meshed = _pair(cfg, mu_guess=25.0)
    state = sched.init(meshed, 8, seed=4, device="cpu")
    state, _ = sched.observe(state, _telem(8, 32, seed=70), meshed)
    mgr = CheckpointManager(str(Path(directory) / f"ckpt{rank}"), async_write=False)
    mgr.save(1, {"sched": state})
    restored, _ = mgr.restore({"sched": sched.init(meshed, 8, seed=9, device="cpu")})
    return {**flat("saved", state), **flat("restored", restored["sched"])}


CASES = ("plumbing", "k1", "gibbs", "fit_dag", "hier", "sched", "checkpoint")


def rank_main(rank, world, directory):
    import torch
    import torch.distributed as dist
    from repro_torch.core.sharding import ShardingConfig

    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(directory) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    results, errors = {}, {}
    try:
        cfg = ShardingConfig.auto()
        for name in CASES:
            case = globals()[f"case_{name}"]
            try:
                got = case(cfg, directory, rank) if name == "checkpoint" else case(cfg)
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
# the reference, in a JAX process of 8 host devices
# --------------------------------------------------------------------------
def reference_main(directory):
    import jax
    import jax.numpy as jnp
    from repro import hier
    from repro.core.gibbs import GibbsState
    from repro.core.moments import BetaParams
    from repro.core.posterior import NormalGammaParams
    from repro.core.sharding import ShardingConfig
    from repro.kernels import ops

    cfg = ShardingConfig.auto()
    x = {k: jnp.asarray(v) for k, v in k1_inputs().items()}
    prior = BetaParams(x["pa"], x["pb"])
    out = {"k1": np.asarray(ops.posterior_grid_fleet(
        x["grid"], x["t"], x["f"], x["mu"], x["lam"], x["alpha"], x["beta"], prior, prior,
        sharding=cfg)), "num_shards": np.array(cfg.num_shards)}

    h = {k: jnp.asarray(v) for k, v in hier_fleet().items()}
    fleet = GibbsState(NormalGammaParams(h["mu0"], h["kappa0"], h["nu0"], h["psi0"]),
                       BetaParams(h["aa"], h["ab"]), BetaParams(h["ba"], h["bb"]),
                       h["mu"], h["lam"], h["alpha"], h["beta"],
                       jax.random.split(jax.random.PRNGKey(0), HIER_K))
    # jitted: the eager shard_map of these bodies takes ~10 s a call on the CPU
    hyper = jax.jit(lambda fl: hier.fit_hyperprior_sharded(fl, cfg))(fleet)
    masked = jax.jit(lambda fl, m: hier.fit_hyperprior_sharded(fl, cfg, m))(
        fleet, jnp.asarray(HIER_MASK))
    h0 = hier.fit_hyperprior(fleet)
    shrunk = jax.jit(lambda fl, h: hier.shrink(fl, h, sharding=cfg))(fleet, h0)
    leaves = lambda prefix, tree: {
        f"{prefix}.{i}": np.asarray(v) for i, v in enumerate(jax.tree_util.tree_leaves(tree))}
    out.update(leaves("fit", hyper), **leaves("fit_masked", masked),
               **leaves("shrink", shrunk._replace(key=None)))
    out["surprise"] = np.asarray(jax.jit(lambda fl, h: hier.surprise(fl, h, sharding=cfg))(fleet, h0))
    np.savez(Path(directory) / "reference.npz", **out)


if __name__ == "__main__":
    reference_main(sys.argv[1])
