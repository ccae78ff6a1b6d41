"""Gradient compression with error feedback on the port
(``repro_torch.distributed.compression``) against the reference's.

Both schemes compute the same float32 operations in the same order, so
``sent`` and the error feedback are held to the reference bit for bit
(signs of zero included) over two chained calls on a small tree of the
port's kind: a dict (sorted keys) holding a matrix, a list with a stacked
3-D leaf, and a vector.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro_torch.distributed import compression as tcomp
from repro_torch.models.params import leaves


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(48, 40)).astype(np.float32),
        "blocks": [rng.normal(0, 0.02, (3, 16, 24)).astype(np.float32),
                   rng.normal(0, 5.0, (37,)).astype(np.float32)],
        "b": rng.normal(0, 1e-3, (40,)).astype(np.float32),
    }


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _assert_bitwise(got_tree, want_tree):
    got = [t.numpy() for t in leaves(got_tree)]
    want = jax.tree_util.tree_leaves(want_tree)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("kind", ["int8_ef", "topk_ef"])
@pytest.mark.parametrize("ratio", [0.01, 0.05])
def test_two_chained_calls_match_reference_bitwise(kind, ratio):
    tc, tinit = tcomp.make_compressor(kind, None, ratio=ratio)
    jc, jinit = jcomp.make_compressor(kind, None, ratio=ratio)
    t_ef = tinit(jax.tree_util.tree_map(torch.as_tensor, _tree(0)))
    j_ef = jinit(jax.tree_util.tree_map(jnp.asarray, _tree(0)))
    for call in range(2):
        g = _tree(call + 1)
        t_sent, t_ef = tc(jax.tree_util.tree_map(torch.as_tensor, g), t_ef)
        j_sent, j_ef = jc(jax.tree_util.tree_map(jnp.asarray, g), j_ef)
        _assert_bitwise(t_sent, j_sent)
        _assert_bitwise(t_ef, j_ef)
        assert all(e.dtype == torch.float32 for e in leaves(t_ef))
        assert isinstance(t_sent, dict) and isinstance(t_sent["blocks"], list)


@pytest.mark.parametrize("kind", ["int8_ef", "topk_ef"])
def test_compression_error_feedback(kind):
    """tests/test_runtime.py's invariant and density test on the port."""
    grads = {"w": torch.as_tensor(np.random.default_rng(0).normal(size=(64, 64)),
                                  dtype=torch.float32)}
    compress, init_ef = tcomp.make_compressor(kind, None, ratio=0.05)
    ef = init_ef(grads)
    sent, ef2 = compress(grads, ef)
    np.testing.assert_allclose((sent["w"] + ef2["w"]).numpy(), grads["w"].numpy(),
                               rtol=1e-5, atol=1e-5)
    if kind == "topk_ef":
        assert float((sent["w"] != 0).float().mean()) <= 0.08  # ~5% density requested


def test_topk_keeps_every_tie_of_the_threshold_as_the_reference():
    """k = 2 of 10 entries, four tied at the largest magnitude: both
    packages keep all four."""
    g = np.array([3.0, -1.0, -3.0, 0.5, 3.0, 2.0, -3.0, 0.25, 1.0, 0.0], np.float32)
    tc, tinit = tcomp.make_compressor("topk_ef", None, ratio=0.2)
    jc, jinit = jcomp.make_compressor("topk_ef", None, ratio=0.2)
    t_sent, t_ef = tc({"g": torch.as_tensor(g)}, tinit({"g": torch.as_tensor(g)}))
    j_sent, j_ef = jc({"g": jnp.asarray(g)}, jinit({"g": jnp.asarray(g)}))
    kept = t_sent["g"].numpy() != 0
    assert kept.sum() == 4 and (np.abs(g[kept]) == 3.0).all()
    _assert_bitwise(t_sent, j_sent)
    _assert_bitwise(t_ef, j_ef)


def test_int8_divides_by_the_scale_as_the_reference():
    """Entries a few ulps either side of half-integer multiples of the
    scale, where g / scale and g * (1 / scale) round to different int8
    steps: the port must divide, as the reference does."""
    f32 = np.float32
    scale = f32(f32(f32(3.0) / f32(127.0)) + f32(1e-12))
    near = []
    for n in range(-126, 126):
        lo = hi = f32((n + 0.5) * scale)
        near.append(lo)
        for _ in range(4):  # four ulps either side
            lo, hi = np.nextafter(lo, f32(-np.inf)), np.nextafter(hi, f32(np.inf))
            near += [lo, hi]
    g = np.asarray([3.0] + near, f32)
    apart = np.round(g / scale) != np.round(g * (f32(1.0) / scale))
    assert apart.sum() > 10  # the inputs tell the two apart
    tc, tinit = tcomp.make_compressor("int8_ef", None)
    jc, jinit = jcomp.make_compressor("int8_ef", None)
    _assert_bitwise(tc({"g": torch.as_tensor(g)}, tinit({"g": torch.as_tensor(g)}))[0],
                    jc({"g": jnp.asarray(g)}, jinit({"g": jnp.asarray(g)}))[0])


def test_int8_sends_integers_times_the_scale():
    g = torch.as_tensor(np.random.default_rng(4).normal(size=(33, 7)), dtype=torch.float32)
    compress, init_ef = tcomp.make_compressor("int8_ef", None)
    sent, _ = compress({"g": g}, init_ef({"g": g}))
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.round(sent["g"] / scale)
    assert torch.equal(q * scale, sent["g"]) and float(q.abs().max()) == 127.0


def test_unknown_kind_raises_value_error_as_the_reference():
    tc, tinit = tcomp.make_compressor("fp8_ef", None)
    jc, jinit = jcomp.make_compressor("fp8_ef", None)
    g = np.ones(4, np.float32)
    with pytest.raises(ValueError, match="fp8_ef"):
        tc({"g": torch.as_tensor(g)}, tinit({"g": torch.as_tensor(g)}))
    with pytest.raises(ValueError, match="fp8_ef"):
        jc({"g": jnp.asarray(g)}, jinit({"g": jnp.asarray(g)}))
