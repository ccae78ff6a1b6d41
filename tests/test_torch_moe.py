"""The port's MoE family (``repro_torch.models.moe``) against the reference.

Weights are drawn with numpy from a seed along the reference's parameter
spec and cross over through ``repro_torch.convert.model_params_from_jax``;
inputs are numpy draws handed to both packages.  The reference's model calls
are jitted; everything runs on the CPU.

The sharp part is which tokens each expert keeps: positions, the keep mask
and the expert ids are held bitwise, at a capacity factor that drops tokens
(0.5) as well as at the reduced configs' dropless 4.0, which would hide a
wrong drop order.

Tolerances: float32 modules at 1e-5 (the same formulation, matmuls summed
in other orders); the dispatch buffers exactly (each kept row is one copy,
a dropped one adds zeros); whole float32 models at tests/test_torch_models.py's
rtol 1e-4, atol 2e-5.  bfloat16: a module's output within 2^-7 relative
(two roundings of one bfloat16 product, 2^-8 each) and 1e-2 absolute; a
whole bfloat16 model's logits within 5e-2 (rounding compounds through two
layers), with the routing itself held bitwise at the first layer.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as jreduced
from repro.models import layers as jl
from repro.models import model_zoo as jz
from repro.models import moe as jm
from repro.models.params import P as JP
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.models import layers as tl
from repro_torch.models import model_zoo as tz
from repro_torch.models import moe as tm
from repro_torch.models.params import tree_map as ttree_map

NAMES = ["granite-moe-3b-a800m", "arctic-480b"]  # top-k only; top-k plus a dense residual
DROPPING = 0.5  # capacity factor below 1: every call drops tokens
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=1e-2)
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_MODEL_TOL = dict(rtol=5e-2, atol=5e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _model(name, dtype="float32", capacity_factor=None):
    """(reference config, port config, reference params, port params) of the
    reduced arch, weights in ``dtype``."""
    over = dict(dtype=dtype)
    if capacity_factor is not None:
        over["capacity_factor"] = capacity_factor
    jcfg = jreduced(ARCHS[name], **over)
    tcfg = reduced(get_arch(name), **over)
    rng = np.random.default_rng(0)

    def draw(p):
        if p.init in ("zeros", "ones"):
            x = np.full(p.shape, float(p.init == "ones"), np.float32)
        else:
            x = (p.scale * rng.normal(size=p.shape)).astype(np.float32)
        return x.astype(DTYPES[dtype][0])

    tree = jax.tree_util.tree_map(draw, jz.model_spec(jcfg), is_leaf=lambda x: isinstance(x, JP))
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), convert.model_params_from_jax(tree, "cpu")


def _ffn(name, dtype="float32", capacity_factor=None):
    """Cycle 0's MoE FFN parameters in both packages, and both configs."""
    jcfg, tcfg, jp, tp = _model(name, dtype, capacity_factor)
    return (jcfg, tcfg, jax.tree_util.tree_map(lambda a: a[0], jp["cycles"][0]["ffn"]),
            ttree_map(lambda a: a[0], tp["cycles"][0]["ffn"]))


def _x(shape, seed=0, dtype="float32"):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# router, dispatch, combine, experts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_route_matches_reference(name, dtype):
    """Router probabilities (float32), renormalised top-k gates in x's dtype
    and expert ids, at 64 tokens."""
    jcfg, tcfg, jp, tp = _ffn(name, dtype)
    jx, tx = _x((64, 64), seed=1, dtype=dtype)
    jprobs, jgates, jexp = jm._route(jcfg, jp["router"], jx)
    tprobs, tgates, texp = tm._route(tcfg, tp["router"], tx)
    assert tgates.dtype == DTYPES[dtype][1] and texp.dtype == torch.int32
    _close(tprobs, jprobs, F32_TOL)
    _same(texp, jexp)
    _close(tgates, jgates, F32_TOL if dtype == "float32" else dict(rtol=2**-8, atol=0))


def test_route_breaks_ties_to_the_lower_expert():
    """A zero router gives every expert the same probability: lax.top_k
    takes experts 0..k-1 in order, and so must the port."""
    jcfg, tcfg, jp, tp = _ffn("granite-moe-3b-a800m")
    jx, tx = _x((16, 64), seed=2)
    zeros = np.zeros((64, tcfg.num_experts), np.float32)
    jprobs, jgates, jexp = jm._route(jcfg, jnp.asarray(zeros), jx)
    tprobs, tgates, texp = tm._route(tcfg, torch.as_tensor(zeros), tx)
    want = np.tile(np.arange(tcfg.experts_per_token, dtype=np.int32), (16, 1))
    np.testing.assert_array_equal(np.asarray(jexp), want)
    _same(texp, jexp)
    _close(tgates, jgates, F32_TOL)
    _close(tprobs, jprobs, F32_TOL)


@pytest.mark.parametrize("capacity_factor", [DROPPING, 1.0, 4.0])
def test_dispatch_and_combine_match_reference(capacity_factor):
    """Positions, keep mask and expert ids bitwise, the (E, C, D) buffers
    exactly, and the combine of given expert outputs, at 48 tokens with the
    router's experts and gates.  At 0.5 and 1.0 some (token, slot) pairs
    are dropped: their zero rows land at position 0 of a kept row."""
    jcfg, tcfg, jp, tp = _ffn("granite-moe-3b-a800m", capacity_factor=capacity_factor)
    jx, tx = _x((48, 64), seed=3)
    _, jgates, jexp = jm._route(jcfg, jp["router"], jx)
    _, tgates, texp = tm._route(tcfg, tp["router"], tx)
    cap = tm._capacity(48, tcfg)
    assert cap == jm._capacity(48, jcfg)
    jbuf, _, jpos, jkeep = jm._dispatch_local(jx, jgates, jexp, jcfg.num_experts, cap)
    tbuf, texp2, tpos, tkeep = tm._dispatch_local(tx, tgates, texp, tcfg.num_experts, cap)
    _same(tpos, jpos)
    _same(tkeep, jkeep)
    _same(texp2, jexp)
    _same(tbuf, jbuf)
    dropped = int((~tkeep).sum())
    assert (dropped > 0) == (capacity_factor < 4.0)

    jy, ty = _x(tuple(tbuf.shape), seed=4)
    _close(tm._combine_local(ty, tgates, texp, tpos, tkeep),
           jm._combine_local(jy, jgates, jexp, jpos, jkeep), F32_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_expert_ffn_matches_reference(dtype):
    jcfg, tcfg, jp, tp = _ffn("arctic-480b", dtype)
    jx, tx = _x((tcfg.num_experts, 5, 64), seed=5, dtype=dtype)
    want = jm._expert_ffn(jcfg, jp["wi"], jp["wg"], jp["wo"], jx)
    got = tm._expert_ffn(tcfg, tp["wi"], tp["wg"], tp["wo"], tx)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("capacity_factor", [DROPPING, 4.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_moe_ffn_and_load_balance_loss_match_reference(name, dtype, capacity_factor):
    """The whole sublayer over (3, 16) tokens, arctic with its parallel dense
    residual FFN, and the load-balance loss of its router probabilities."""
    jcfg, tcfg, jp, tp = _ffn(name, dtype, capacity_factor)
    assert tcfg.moe_residual == (name == "arctic-480b")
    jx, tx = _x((3, 16, 64), seed=6, dtype=dtype)
    want, jprobs = jm.moe_ffn(jcfg, jp, jx, jl.ApplyCtx(mode="train"))
    got, tprobs = tm.moe_ffn(tcfg, tp, tx)
    assert got.shape == (3, 16, 64) and got.dtype == DTYPES[dtype][1]
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
    _close(tprobs, jprobs, F32_TOL)
    _close(tm.load_balance_loss(tcfg, tprobs), jm.load_balance_loss(jcfg, jprobs), F32_TOL)


def test_load_balance_loss_breaks_ties_as_the_reference():
    """Uniform probabilities: the top-1 expert of every token is expert 0
    (the first maximum), so the loss is E x (1/E) x 1 = 1 in both."""
    jcfg, tcfg, _, _ = _ffn("granite-moe-3b-a800m")
    probs = np.full((10, tcfg.num_experts), 1.0 / tcfg.num_experts, np.float32)
    got = tm.load_balance_loss(tcfg, torch.as_tensor(probs))
    _close(got, jm.load_balance_loss(jcfg, jnp.asarray(probs)), F32_TOL)
    assert float(got) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# whole reduced models at a dropping capacity factor
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jitted(name, dtype, capacity_factor, fn):
    jcfg = _model(name, dtype, capacity_factor)[0]
    if fn == "forward_train":
        ctx = jl.ApplyCtx(mode="train")
        return jax.jit(lambda p, t: jz.forward_train(jcfg, p, {"tokens": t}, ctx=ctx))
    if fn == "prefill":
        ctx = jl.ApplyCtx(mode="prefill")
        return jax.jit(lambda p, t, c: jz.prefill(jcfg, p, {"tokens": t}, c, ctx=ctx))
    ctx = jl.ApplyCtx(mode="decode")
    return jax.jit(lambda p, t, c: jz.decode_step(jcfg, p, t, c, ctx=ctx))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_reduced_model_drops_the_references_tokens(name, dtype):
    """At capacity factor 0.5: the train-mode forward's logits and summed
    load-balance loss, then prefill of 8 tokens and 4 decode steps (a decode
    step's 2 tokens get capacity 1 of 2 slots each), against the reference.
    In bfloat16 the first layer's routing is also held bitwise."""
    jcfg, tcfg, jp, tp = _model(name, dtype, DROPPING)
    tol = MODEL_TOL if dtype == "float32" else BF16_MODEL_TOL
    b, t, k = 2, 12, 8
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (b, t)).astype(np.int32)
    want, jaux = _jitted(name, dtype, DROPPING, "forward_train")(jp, jnp.asarray(toks))
    got, taux = tz.forward_train(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                                 ctx=tl.ApplyCtx(mode="train"))
    _close(got, want, tol)
    _close(taux, jaux, F32_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-3))
    assert float(taux) > 0.0

    if dtype == "bfloat16":  # the first MoE layer sees the same inputs: the same drops
        jx = jz.transformer._embed(jcfg, jp, jnp.asarray(toks), None)
        tx = tz.transformer._embed(tcfg, tp, torch.as_tensor(toks))
        jb = jax.tree_util.tree_map(lambda a: a[0], jp["cycles"][0])
        tb = ttree_map(lambda a: a[0], tp["cycles"][0])
        jh, _, _ = jz.transformer.block_apply(jcfg, "moe", {k_: v for k_, v in jb.items() if k_ != "ffn"},
                                              jx, ctx=jl.ApplyCtx(mode="train"),
                                              positions=jnp.arange(t), length=None, cache=None)
        th, _ = tz.transformer.block_apply(tcfg, "moe", {k_: v for k_, v in tb.items() if k_ != "ffn"},
                                           tx, ctx=tl.ApplyCtx(mode="train"),
                                           positions=torch.arange(t), length=None, cache=None)
        jflat = jl.rmsnorm(jb["ln2"], jh, jcfg.norm_eps).reshape(b * t, -1)
        tflat = tl.rmsnorm(tb["ln2"], th, tcfg.norm_eps).reshape(b * t, -1)
        _, jg, je = jm._route(jcfg, jb["ffn"]["router"], jflat)
        _, tg, te = tm._route(tcfg, tb["ffn"]["router"], tflat)
        _same(te, je)
        cap = tm._capacity(b * t, tcfg)
        _same(tm._dispatch_local(tflat, tg, te, tcfg.num_experts, cap)[3],
              jm._dispatch_local(jflat, jg, je, jcfg.num_experts, cap)[3])

    jcache = jz.init_cache(jcfg, b, 32, jnp.float32)
    tcache = tz.init_cache(tcfg, b, 32, torch.float32, device="cpu")
    want, jcache = _jitted(name, dtype, DROPPING, "prefill")(jp, jnp.asarray(toks[:, :k]), jcache)
    got, tcache = tz.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks[:, :k])}, tcache,
                             ctx=tl.ApplyCtx(mode="prefill"))
    _close(got, want, tol)
    for j in range(k, t):
        want, jcache = _jitted(name, dtype, DROPPING, "decode")(jp, jnp.asarray(toks[:, j:j + 1]),
                                                                jcache)
        got, tcache = tz.decode_step(tcfg, tp, torch.as_tensor(toks[:, j:j + 1]), tcache,
                                     ctx=tl.ApplyCtx(mode="decode"))
        _close(got, want, tol)


def test_moe_params_carry_over_leaf_for_leaf():
    """convert.model_params_from_jax keeps the MoE leaves' shapes and values:
    router (d, E), wi and wg (E, d, f), wo (E, f, d), arctic's res_* leaves,
    each with the leading n_cycles axis."""
    jcfg, tcfg, jp, tp = _model("arctic-480b", "bfloat16")
    e, d, f, n = tcfg.num_experts, tcfg.d_model, tcfg.d_ff, tcfg.num_layers
    shapes = dict(router=(n, d, e), wi=(n, e, d, f), wg=(n, e, d, f), wo=(n, e, f, d),
                  res_wi=(n, d, f), res_wg=(n, d, f), res_wo=(n, f, d))
    ffn_j, ffn_t = jp["cycles"][0]["ffn"], tp["cycles"][0]["ffn"]
    assert sorted(ffn_t) == sorted(shapes)
    for key, shape in shapes.items():
        assert tuple(ffn_t[key].shape) == shape and ffn_t[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(ffn_t[key].float().numpy(),
                                      np.asarray(ffn_j[key].astype(jnp.float32)))


@pytest.mark.parametrize("name", NAMES)
def test_active_param_count_matches_reference(name):
    """Full width, counted without allocating: the parameters one token
    uses (experts at k/E), as the reference's active_only count."""
    assert tz.param_count(get_arch(name), active_only=True) == jz.param_count(
        ARCHS[name], active_only=True)
