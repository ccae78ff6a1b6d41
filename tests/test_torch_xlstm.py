"""The port's ssm family (mLSTM and sLSTM in ``repro_torch.models.recurrent``)
against the reference, block by block, at the reduced xlstm-1.3b's widths
(d_model 64, 4 heads of 16).

Weights are numpy draws along the reference's block specs and cross over
through ``repro_torch.convert.model_params_from_jax``; inputs and the
incoming caches are numpy draws handed to both packages.  The reference
initialises the gate biases to zeros; here they come from N(0, 0.1^2), and
in the stress draws from N(0, 3^2) with the inputs scaled by 4, so that the
stabiliser m follows log i and the mLSTM normaliser's floor exp(-m) binds
in some rows and not in others.  The whole reduced model (both kinds in
one stack) is tests/test_torch_models.py's, through its ``ARCH_NAMES``.

Tolerances: float32 at tests/test_torch_models.py's MOD_TOL (the same
formulation, matmuls and cumulative sums in other orders; measured below
5e-7 of each tensor's largest |value|).  bfloat16 parameters and
inputs: within BF16_REL = 2^-6 of the compared tensor's largest |value|
(four bfloat16 ulps of it), against at most 6.6e-3 measured on these draws
(the mLSTM's stress outputs: one ulp of an output where XLA and PyTorch
round a bfloat16 product or gate differently).  The sLSTM's outputs in
bfloat16 came out bitwise equal.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as jreduced
from repro.models import layers as jl
from repro.models import recurrent as jr
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.models import layers as tl
from repro_torch.models import recurrent as tr
from test_torch_models import MOD_TOL

NAME = "xlstm-1.3b"
BF16_REL = 2**-6
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STRESS_BIAS, STRESS_SCALE = 3.0, 4.0  # the stress draws' bias std and input scale
B, T, STEPS = 2, 7, 4  # prefill T positions, then STEPS decode steps
STATE_KEYS = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread: the suite's worker processes would oversubscribe
    the cores (tests/test_torch_dag.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


JCFG = jreduced(ARCHS[NAME])
TCFG = reduced(get_arch(NAME))


@functools.lru_cache(maxsize=None)
def _params(kind, dtype="float32", stress=False):
    """One block's parameters in both packages: normal(0, scale) leaves, the
    biases from N(0, 0.1^2) (N(0, STRESS_BIAS^2) with ``stress``)."""
    spec = {"mlstm": jr.mlstm_spec, "slstm": jr.slstm_spec}[kind](JCFG)
    rng = np.random.default_rng(0)
    bias_std = STRESS_BIAS if stress else 0.1
    tree = {key: ((bias_std if p.init == "zeros" else p.scale) * rng.normal(size=p.shape))
            .astype(np.float32).astype(DTYPES[dtype][0]) for key, p in sorted(spec.items())}
    return {k: jnp.asarray(v) for k, v in tree.items()}, convert.model_params_from_jax(tree, "cpu")


def _x(shape, stress, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x * (STRESS_SCALE if stress else 1.0)


def _inputs(x, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)


def _nonempty_cache(kind, seed=1):
    """A numpy state that is not the initial one, for both packages."""
    rng = np.random.default_rng(seed)
    hd = JCFG.d_model // JCFG.num_heads
    h = JCFG.num_heads
    if kind == "mlstm":
        shapes = dict(C=(B, h, hd, hd), n=(B, h, hd), m=(B, h))
    else:
        shapes = {key: (B, h, hd) for key in STATE_KEYS["slstm"]}
    cache = {key: (0.3 * rng.normal(size=shape)).astype(np.float32) for key, shape in shapes.items()}
    if kind == "slstm":
        cache["n"] = np.abs(cache["n"]) + 0.5  # a normaliser, as the steps leave it
    return cache


def _close(got, want, dtype="float32"):
    want = np.asarray(want, np.float32)
    tol = MOD_TOL if dtype == "float32" else dict(rtol=0, atol=BF16_REL * np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _block(kind):
    return {"mlstm": (jr.mlstm_block, tr.mlstm_block), "slstm": (jr.slstm_block, tr.slstm_block)}[kind]


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mlstm_across_query_chunks_matches_reference(mode):
    """12 positions at q_chunk 4 (three query chunks; the reference scans
    them) against the reference, and against the port's single chunk; in
    prefill the final state too."""
    jp, tp = _params("mlstm")
    x = _x((B, 12, JCFG.d_model), stress=False, seed=3)
    jx, tx = _inputs(x, "float32")
    want, jstate = jr.mlstm_block(JCFG, jp, jx, ctx=jl.ApplyCtx(mode=mode, q_chunk=4))
    outs = {}
    for q_chunk in (4, 2048):
        cache = tr.init_mlstm_cache(TCFG, B, "cpu") if mode == "prefill" else None
        got, cache = tr.mlstm_block(TCFG, tp, tx, ctx=tl.ApplyCtx(mode=mode, q_chunk=q_chunk),
                                    cache=cache)
        _close(got, want)
        outs[q_chunk] = (got, cache)
        if mode == "prefill":
            for key in STATE_KEYS["mlstm"]:
                _close(cache[key], jstate[key])
    torch.testing.assert_close(outs[4][0], outs[2048][0], **MOD_TOL)


@pytest.mark.parametrize("stress", [False, True], ids=["plain", "stress"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_train_prefill_and_decode_match_reference(kind, dtype, stress):
    """Train mode over T + STEPS positions; prefill of T positions into a
    cache that is not empty (the mLSTM starts from the zero state whatever
    the cache holds, the sLSTM from the cache); then STEPS decode steps, each
    output and the state after each step against the reference.  The state
    is float32 and written in place in the port's cache."""
    jfn, tfn = _block(kind)
    jp, tp = _params(kind, dtype, stress)
    jx, tx = _inputs(_x((B, T + STEPS, JCFG.d_model), stress), dtype)

    want, _ = jfn(JCFG, jp, jx, ctx=jl.ApplyCtx(mode="train"))
    got, _ = tfn(TCFG, tp, tx, ctx=tl.ApplyCtx(mode="train"))
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)

    start = _nonempty_cache(kind)
    jcache = {key: jnp.asarray(v) for key, v in start.items()}
    tcache = {key: torch.tensor(v) for key, v in start.items()}
    views = dict(tcache)  # the tensors the port must write through
    want, jcache = jfn(JCFG, jp, jx[:, :T], ctx=jl.ApplyCtx(mode="prefill"), cache=jcache)
    got, out = tfn(TCFG, tp, tx[:, :T], ctx=tl.ApplyCtx(mode="prefill"), cache=tcache)
    _close(got, want, dtype)
    binds = []
    for i in range(T, T + STEPS + 1):
        assert all(out[key] is views[key] for key in views)
        for key in STATE_KEYS[kind]:
            assert tcache[key].dtype == torch.float32
            _close(tcache[key], jcache[key], dtype)
        if i == T + STEPS:
            break
        want, jcache = jfn(JCFG, jp, jx[:, i:i + 1], ctx=jl.ApplyCtx(mode="decode"), cache=jcache)
        got, out = tfn(TCFG, tp, tx[:, i:i + 1], ctx=tl.ApplyCtx(mode="decode"), cache=tcache)
        _close(got, want, dtype)
        if kind == "mlstm":  # where the decode normaliser's floor exp(-m) binds
            q = tr._mlstm_qkv(TCFG, tp, tx[:, i:i + 1])[0][:, :, 0].float()
            dot = torch.einsum("bhk,bhk->bh", tcache["n"], q).abs()
            binds.append(dot < torch.exp(-tcache["m"]))
    if kind == "mlstm" and stress:
        binds = torch.stack(binds)
        assert bool(binds.any()) and not bool(binds.all())


def test_slstm_prefill_continues_from_the_cache():
    """The sLSTM's prefill of x[:, 4:] from the state prefill of x[:, :4]
    left is the prefill of all of x: the loop starts from the cache's state."""
    _, tp = _params("slstm")
    x = torch.as_tensor(_x((B, 8, TCFG.d_model), stress=False, seed=5))
    whole = tr.init_slstm_cache(TCFG, B, "cpu")
    want, _ = tr.slstm_block(TCFG, tp, x, ctx=tl.ApplyCtx(mode="prefill"), cache=whole)
    cache = tr.init_slstm_cache(TCFG, B, "cpu")
    first, _ = tr.slstm_block(TCFG, tp, x[:, :4], ctx=tl.ApplyCtx(mode="prefill"), cache=cache)
    second, _ = tr.slstm_block(TCFG, tp, x[:, 4:], ctx=tl.ApplyCtx(mode="prefill"), cache=cache)
    torch.testing.assert_close(torch.cat([first, second], dim=1), want, **MOD_TOL)
    for key in STATE_KEYS["slstm"]:
        torch.testing.assert_close(cache[key], whole[key], **MOD_TOL)


def test_mlstm_decode_from_the_initial_cache_matches_reference():
    """A decode step from the initial cache (m = -1e30, C = n = 0): the
    forget term vanishes and the state is the step's own input."""
    jp, tp = _params("mlstm")
    jx, tx = _inputs(_x((B, 1, JCFG.d_model), stress=False, seed=6), "float32")
    want, jstate = jr.mlstm_block(JCFG, jp, jx, ctx=jl.ApplyCtx(mode="decode"),
                                  cache=jr.init_mlstm_cache(JCFG, B))
    cache = tr.init_mlstm_cache(TCFG, B, "cpu")
    got, _ = tr.mlstm_block(TCFG, tp, tx, ctx=tl.ApplyCtx(mode="decode"), cache=cache)
    _close(got, want)
    for key in STATE_KEYS["mlstm"]:
        _close(cache[key], jstate[key])
