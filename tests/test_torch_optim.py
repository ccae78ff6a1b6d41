"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's.

The same numpy trees go through both packages.  Tolerances: float32 leaves
and moments at rtol 1e-6, atol 1e-7 (the same float32 operations in the same
order; XLA and PyTorch may fuse a multiply-add differently, a few ulps);
a bfloat16 leaf or moment within one bfloat16 ulp of the reference's (the
float32 result rounded once, where a few-ulp float32 difference can land on
the other side of a rounding boundary).  The global norm is a sum of
per-leaf sums, in float32 at rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ja
from repro_torch import convert
from repro_torch.models.params import leaves as tleaves
from repro_torch.optim import adamw as ta

F32 = dict(rtol=1e-6, atol=1e-7)
BF16_ULP = 2.0**-7  # relative spacing of bfloat16 values at most


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.normal(size=(3, 4))).astype(np.float32),
            "b": [(scale * rng.normal(size=(5,))).astype(np.float32),
                  {"c": (scale * rng.normal(size=(2, 2, 3))).astype(np.float32)}]}


def jtree(t, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), t)


def ttree(t):
    return convert.model_params_from_jax(t, "cpu")


def leaves(t):
    return jax.tree_util.tree_leaves(t)


def assert_leaf(got, want, bf16):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if bf16:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-30)
    else:
        np.testing.assert_allclose(got, want, **F32)


def test_init_matches_reference():
    t = tree(0)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got, want = ta.init(ttree(t), dtype=dt), ja.init(jtree(t), dtype=jdt)
        assert got.count.dtype == torch.int32 and int(got.count) == int(want.count) == 0
        for g, w in zip(tleaves(got.m) + tleaves(got.v), leaves(want.m) + leaves(want.v)):
            assert g.dtype == dt and tuple(g.shape) == w.shape and not g.any()


@pytest.mark.parametrize("scale", [0.01, 10.0])  # a global norm below and above the clip 1.0
def test_global_norm_and_clip_match_reference(scale):
    t = tree(1, scale)
    np.testing.assert_allclose(float(ta.global_norm(ttree(t))), float(ja.global_norm(jtree(t))),
                               **F32)
    got, gn = ta.clip_by_global_norm(ttree(t), 1.0)
    want, wn = ja.clip_by_global_norm(jtree(t), 1.0)
    np.testing.assert_allclose(float(gn), float(wn), **F32)
    for g, w in zip(tleaves(got), leaves(want)):
        assert_leaf(g, w, bf16=False)
    if scale < 1:  # below the clip: unchanged
        for g, x in zip(tleaves(got), leaves(t)):
            np.testing.assert_array_equal(g.numpy(), x)


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_matches_reference_over_three_steps(grad_clip, param_dtype, moment_dtype):
    """Three updates from the same parameters and moments, the gradients
    above the clip (global norm ~4.9): parameters, m, v, count and the norm
    after each."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    p0 = tree(2)
    jp = jtree(p0, jdt[param_dtype])
    tp = ttree(jax.tree_util.tree_map(np.asarray, jp))
    js = ja.init(jp, dtype=jdt[moment_dtype])
    tsx = ta.init(tp, dtype=tdt[moment_dtype])
    for step in range(3):
        g = tree(10 + step)
        lr = 1e-2 * (step + 1)
        jp, js, jn = ja.apply(jp, jtree(g, jdt[param_dtype]), js, jnp.float32(lr),
                              grad_clip=grad_clip)
        tg = ttree(jax.tree_util.tree_map(np.asarray, jtree(g, jdt[param_dtype])))
        tp, tsx, tn = ta.apply(tp, tg, tsx, torch.tensor(lr), grad_clip=grad_clip)
        np.testing.assert_allclose(float(tn), float(jn), **F32)
        assert int(tsx.count) == int(js.count) == step + 1
        for g_, w in zip(tleaves(tp), leaves(jp)):
            assert g_.dtype == tdt[param_dtype]
            assert_leaf(g_, w, bf16=param_dtype == "bfloat16")
        for g_, w in zip(tleaves(tsx.m) + tleaves(tsx.v), leaves(js.m) + leaves(js.v)):
            assert g_.dtype == tdt[moment_dtype]
            assert_leaf(g_, w, bf16=moment_dtype == "bfloat16")


def test_apply_leaves_its_inputs_unchanged():
    t = tree(3)
    tp, g = ttree(t), ttree(tree(4))
    st = ta.init(tp)
    ta.apply(tp, g, st, torch.tensor(0.1))
    for x, want in zip(tleaves(tp), leaves(t)):
        np.testing.assert_array_equal(x.numpy(), want)
    assert int(st.count) == 0 and not any(m.any() for m in tleaves(st.m))


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 130])  # 0, warmup, its end, middle, end, past
def test_cosine_schedule_matches_reference(step):
    got = ta.cosine_schedule(3e-4, 10, 100)(step)
    want = ja.cosine_schedule(3e-4, 10, 100)(jnp.asarray(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)
    if step == 0:
        assert float(got) == 0.0  # the first update is a no-op
    if step >= 100:
        assert float(got) == 0.0
