"""The port's encoder-decoder pieces (``repro_torch.models.encdec``, cross
attention in ``layers.attention``, the ``xdec`` block) against the reference.

Weights are numpy draws along the reference's specs, biases included (the
reference initialises them to zeros, which would test nothing, so here they
come from N(0, 0.1^2): ``test_torch_models.draw_params``); inputs are numpy
draws handed to both packages.
Everything runs in float32 on the CPU, where the decode step's K2 call takes
its plain version.

The sharp part is that a decode step reads the cross cache and writes
nothing to it, at every step: 4 decode steps are each held to the
reference and to the train-mode output at their position, and the cross
cache is held bitwise to what prefill wrote.  Tolerances: modules at 1e-5
(the same float32 formulation, matmuls summed in other orders); the encoder
(two layers and a norm) at tests/test_torch_models.py's whole-model rtol
1e-4, atol 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as jreduced
from repro.models import encdec as je
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.models import encdec as te
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from test_torch_models import draw_params

MOD_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
DECODE_STEPS = 4


def _cfgs(**overrides):
    """reduced whisper-medium in both packages: d_model 64, 4 heads of 16
    over 1 kv head, 2 encoder layers over 16 frames."""
    return (jreduced(ARCHS["whisper-medium"], **overrides),
            reduced(get_arch("whisper-medium"), **overrides))


def _draw(spec, seed):
    """(reference tree, port tree) of one spec, its biases drawn."""
    tree = draw_params(spec, draw_biases=True, seed=seed)
    return jax.tree_util.tree_map(jnp.asarray, tree), convert.model_params_from_jax(tree, "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_encoder_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _draw(je.encoder_spec(jcfg), seed=0)
    assert tp["cycles"][0]["attn"]["wq"].shape[0] == jcfg.encoder_layers
    frames = _x((2, jcfg.encoder_seq, jcfg.d_model), seed=1)
    want = jax.jit(lambda p, f: je.encode(jcfg, p, f, ctx=jl.ApplyCtx(mode="prefill")))(
        jp, jnp.asarray(frames))
    got = te.encode(tcfg, tp, torch.as_tensor(frames), ctx=tl.ApplyCtx(mode="prefill"))
    assert got.shape == frames.shape
    _close(got, want, MODEL_TOL)


def test_encoder_attention_is_not_causal():
    """The last frame changes every encoder output row (a causal mask would
    leave rows before it unchanged)."""
    _, tcfg = _cfgs()
    _, tp = _draw(je.encoder_spec(_cfgs()[0]), seed=0)
    frames = _x((1, tcfg.encoder_seq, tcfg.d_model), seed=2)
    ctx = tl.ApplyCtx(mode="train")
    base = te.encode(tcfg, tp, torch.as_tensor(frames), ctx=ctx)
    frames[:, -1] += 1.0
    moved = te.encode(tcfg, tp, torch.as_tensor(frames), ctx=ctx)
    assert bool(((moved - base).abs().amax(dim=-1) > 1e-4).all())


@pytest.mark.parametrize("use_bias", [True, False])
def test_cross_attention_train_prefill_and_decode_match_reference(use_bias):
    """Cross attention of 6 query tokens (prefill) and then DECODE_STEPS more,
    one at a time, over 16 encoder rows: each against the reference, each
    decode step against the train-mode output at its position, and the cross
    cache unchanged by the decode steps."""
    jcfg, tcfg = _cfgs(use_bias=use_bias)
    jp, tp = _draw(jl.attention_spec(jcfg, cross=True), seed=3)
    assert ("bq" in tp) == use_bias
    b, t, s = 2, 6, jcfg.encoder_seq
    x = _x((b, t + DECODE_STEPS, jcfg.d_model), seed=4)
    enc = _x((b, s, jcfg.d_model), seed=5)
    kw = dict(causal=False, is_cross=True)
    jkw = dict(kw, use_rope=False)  # the port never ropes cross attention

    want, _ = jl.attention(jcfg, jp, jnp.asarray(x), ctx=jl.ApplyCtx(mode="train"),
                           kv_x=jnp.asarray(enc), **jkw)
    train, _ = tl.attention(tcfg, tp, torch.as_tensor(x), ctx=tl.ApplyCtx(mode="train"),
                            kv_x=torch.as_tensor(enc), **kw)
    _close(train, want, MOD_TOL)

    jcache = jl.init_attention_cache(jcfg, b, s, jnp.float32)
    tcache = tl.init_attention_cache(tcfg, b, s, torch.float32, "cpu")
    want, jcache = jl.attention(jcfg, jp, jnp.asarray(x[:, :t]), ctx=jl.ApplyCtx(mode="prefill"),
                                cache=jcache, kv_x=jnp.asarray(enc), **jkw)
    got, tcache = tl.attention(tcfg, tp, torch.as_tensor(x[:, :t]), ctx=tl.ApplyCtx(mode="prefill"),
                               cache=tcache, kv_x=torch.as_tensor(enc), **kw)
    _close(got, want, MOD_TOL)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], MOD_TOL)
    prefilled = {key: tcache[key].clone() for key in ("k", "v")}

    for i in range(t, t + DECODE_STEPS):
        pos, length = np.full((1,), i, np.int32), np.int32(i)
        want, jcache = jl.attention(jcfg, jp, jnp.asarray(x[:, i : i + 1]),
                                    ctx=jl.ApplyCtx(mode="decode"), positions=jnp.asarray(pos),
                                    length=jnp.asarray(length), cache=jcache, **jkw)
        got, tcache = tl.attention(tcfg, tp, torch.as_tensor(x[:, i : i + 1]),
                                   ctx=tl.ApplyCtx(mode="decode"), positions=torch.as_tensor(pos),
                                   length=torch.tensor(i, dtype=torch.int32), cache=tcache, **kw)
        _close(got, want, MOD_TOL)
        _close(got[:, 0], train[:, i].numpy(), MOD_TOL)
    for key in ("k", "v"):
        assert torch.equal(tcache[key], prefilled[key])


def test_cross_attention_outside_decode_needs_the_encoder_output():
    _, tcfg = _cfgs()
    _, tp = _draw(jl.attention_spec(_cfgs()[0], cross=True), seed=3)
    x = torch.as_tensor(_x((1, 3, tcfg.d_model), seed=6))
    for mode in ("train", "prefill"):
        with pytest.raises(ValueError, match="requires kv_x"):
            tl.attention(tcfg, tp, x, ctx=tl.ApplyCtx(mode=mode), is_cross=True)


def test_xdec_block_prefill_and_decode_match_reference():
    """One decoder block (causal self-attention, cross attention, gelu MLP),
    with biases: prefill of 5 tokens, then DECODE_STEPS steps, each against
    the reference; the self cache against the reference's, the cross cache as
    prefill left it."""
    jcfg, tcfg = _cfgs(use_bias=True)
    jp, tp = _draw(jt.block_spec(jcfg, "xdec"), seed=7)
    assert set(tp) == {"ln1", "attn", "lnx", "xattn", "ln2", "ffn"}
    b, t, max_len = 2, 5, 16
    x = 0.5 * _x((b, t + DECODE_STEPS, jcfg.d_model), seed=8)
    enc = _x((b, jcfg.encoder_seq, jcfg.d_model), seed=9)
    jcache = jt.init_block_cache(jcfg, "xdec", b, max_len, jnp.float32)
    tcache = tt.init_block_cache(tcfg, "xdec", b, max_len, torch.float32, "cpu")
    assert tcache["cross"]["k"].shape[1] == jcfg.encoder_seq and tcache["self"]["k"].shape[1] == max_len

    jpos, tpos = jnp.arange(t), torch.arange(t)
    want, jcache, _ = jt.block_apply(jcfg, "xdec", jp, jnp.asarray(x[:, :t]),
                                     ctx=jl.ApplyCtx(mode="prefill"), positions=jpos, length=None,
                                     cache=jcache, enc_out=jnp.asarray(enc))
    got, _ = tt.block_apply(tcfg, "xdec", tp, torch.as_tensor(x[:, :t]),
                            ctx=tl.ApplyCtx(mode="prefill"), positions=tpos, length=None,
                            cache=tcache, enc_out=torch.as_tensor(enc))
    _close(got, want, MOD_TOL)
    prefilled = {key: tcache["cross"][key].clone() for key in ("k", "v")}
    for i in range(t, t + DECODE_STEPS):
        want, jcache, _ = jt.block_apply(
            jcfg, "xdec", jp, jnp.asarray(x[:, i : i + 1]), ctx=jl.ApplyCtx(mode="decode"),
            positions=jnp.full((1,), i, jnp.int32), length=jnp.asarray(i, jnp.int32), cache=jcache)
        got, _ = tt.block_apply(
            tcfg, "xdec", tp, torch.as_tensor(x[:, i : i + 1]), ctx=tl.ApplyCtx(mode="decode"),
            positions=torch.full((1,), i, dtype=torch.int32), length=torch.tensor(i, dtype=torch.int32),
            cache=tcache)
        _close(got, want, MOD_TOL)
    for part in ("self", "cross"):
        for key in ("k", "v"):
            _close(tcache[part][key], jcache[part][key], MOD_TOL)
    for key in ("k", "v"):
        assert torch.equal(tcache["cross"][key], prefilled[key])


def test_encdec_model_spec_and_cache_layout():
    """The whole model's spec holds the encoder beside the decoder, as the
    reference's; the decode cache of every ``xdec`` layer is {self, cross}."""
    from repro.models import model_zoo as jz
    from repro_torch.models import model_zoo as tz

    jcfg, tcfg = _cfgs()
    spec = tz.model_spec(tcfg)
    assert set(spec) == set(jz.model_spec(jcfg)) and "encoder" in spec
    assert tz.param_count(tcfg) == jz.param_count(jcfg)
    cache = tz.init_cache(tcfg, 2, 24, torch.float32, device="cpu")
    layer = cache["cycles"][0]
    assert layer["self"]["k"].shape == (jcfg.num_layers, 2, 24, 1, 16)
    assert layer["cross"]["k"].shape == (jcfg.num_layers, 2, jcfg.encoder_seq, 1, 16)


@pytest.mark.cuda
def test_encdec_serving_on_card_goes_through_k2():
    """Reduced whisper on the card: prefill launches no K2 (the encoder and
    the decoder's prefill attend in full), each decode step launches it twice
    a decoder layer (self, then cross), and the logits match the same model
    on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro.models import model_zoo as jz
    from repro_torch import kernels
    from repro_torch.models import model_zoo as tz
    from repro_torch.models.params import tree_map

    jcfg, tcfg = _cfgs(use_bias=True)
    _, tp = _draw(jz.model_spec(jcfg), seed=10)
    params = tree_map(lambda a: a.cuda(), tp)
    toks = torch.as_tensor(np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 12)),
                           dtype=torch.int32)
    frames = torch.as_tensor(_x((2, tcfg.encoder_seq, tcfg.d_model), seed=12))
    caches = {dev: tz.init_cache(tcfg, 2, 32, torch.float32, device=dev) for dev in ("cuda", "cpu")}
    kernels.reset_launch_counts()
    logits = {}
    for dev, p in (("cuda", params), ("cpu", tp)):
        batch = {"tokens": toks[:, :8].to(dev), "frames": frames.to(dev)}
        logits[dev] = [tz.prefill(tcfg, p, batch, caches[dev], ctx=tl.ApplyCtx(mode="prefill"))[0]]
        if dev == "cuda":
            assert kernels.launch_counts()["decode_attention"] == 0
        for j in range(8, 11):
            logits[dev].append(tz.decode_step(tcfg, p, toks[:, j : j + 1].to(dev), caches[dev],
                                              ctx=tl.ApplyCtx(mode="decode"))[0])
    assert kernels.launch_counts()["decode_attention"] == 2 * tcfg.num_layers * 3
    for got, want in zip(logits["cuda"], logits["cpu"]):
        _close(got.cpu(), want.numpy(), MODEL_TOL)
