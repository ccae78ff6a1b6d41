"""The port's serving path (dense, vision, hybrid, MoE, encoder-decoder and
ssm families) against the reference.

Weights are drawn with numpy from a seed along the reference's parameter
spec, as its ``init_params`` draws them, and cross over to the port through
``repro_torch.convert.model_params_from_jax``; inputs are made with numpy
too and handed to both packages.  The reference initialises biases to zeros;
here an arch with biases (``use_bias``) gets them drawn from N(0, 0.1^2), so
that the tests see them.  The reference's model calls are jitted.
Everything runs in float32 on the CPU, where the port's kernel wrappers take
their plain versions.

Tolerances: modules at 1e-5 (float32, the same formulation; XLA's and
PyTorch's CPU matmuls sum in different orders, about 1e-6 here); the whole
model at rtol 1e-4, atol 2e-5 (the same rounding through up to five layers,
softcapped logits of order 1); the port's own decode-vs-teacher-forcing check
at the whole model's tolerance too, tighter than tests/test_models.py's rtol
2e-2, atol 2e-3: the port's two paths differ by at most 1.9e-6 on logits up
to 9.5, and a state that decode does not find in the cache (an mLSTM cache
left at its initial value) moves xlstm's logits by 2.5e-4, which the
reference's tolerance would let pass.
"""
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as jreduced
from repro.models import layers as jl
from repro.models import model_zoo as jz
from repro.models import recurrent as jr
from repro.models.params import P as JP
from repro.train import serve_step as jss
from repro_torch import convert, kernels
from repro_torch.configs import get_arch, reduced
from repro_torch.models import layers as tl
from repro_torch.models import model_zoo as tz
from repro_torch.models.params import tree_map as ttree_map
from repro_torch.models import recurrent as tr
from repro_torch.train import serve_step as tss

ARCH_NAMES = ["recurrentgemma-2b", "tinyllama-1.1b", "granite-moe-3b-a800m", "arctic-480b",
              "whisper-medium", "internvl2-1b", "yi-9b", "command-r-35b", "xlstm-1.3b"]
# geglu and swiglu, swiglu with biases, and the non-gated gelu; the MoE FFNs
# are tests/test_torch_moe.py's
DENSE_FFN_NAMES = ["recurrentgemma-2b", "tinyllama-1.1b", "internvl2-1b", "whisper-medium"]
# recurrentgemma at a 4-token window and 5 layers: one (rglru, rglru,
# localattn) cycle plus the two unrolled rglru layers of the full model's
# tail; the MoE archs at the reduced configs' dropless capacity factor 4.0;
# the others as ``reduced`` makes them (whisper: 2 encoder layers over 16
# frames; internvl2: 8 vision patches; xlstm: one cycle of 7 mLSTM and 1
# sLSTM layers, 4 heads of 16)
OVERRIDES = {"recurrentgemma-2b": dict(local_window=4, num_layers=5)}
BIAS_SCALE = 0.1  # the standard deviation of drawn biases
MOD_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)


def draw_params(spec, draw_biases, seed=0):
    """Numpy leaves along a reference spec: normal(0, scale), ones and zeros
    as the reference initialises them, except that with ``draw_biases`` the
    zero-initialised leaves (the biases) come from N(0, BIAS_SCALE^2)."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "ones" or (p.init == "zeros" and not draw_biases):
            return np.full(p.shape, float(p.init == "ones"), np.float32)
        scale = BIAS_SCALE if p.init == "zeros" else p.scale
        return (scale * rng.normal(size=p.shape)).astype(np.float32)

    return jax.tree_util.tree_map(draw, spec, is_leaf=lambda x: isinstance(x, JP))


def extra_inputs(cfg, b, seed=0):
    """A vision model's patch embeddings and an encoder-decoder's frames, as
    numpy N(0, 1) draws; {} for a token-only arch."""
    rng = np.random.default_rng(seed + 1000)
    out = {}
    if cfg.vision_patches:
        out["vision"] = rng.normal(size=(b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def batches(tokens, extras):
    """One numpy batch as the reference's and the port's batch dicts."""
    batch = dict(extras, tokens=tokens)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _model(name):
    """(reference config, port config, reference params, port params)."""
    jcfg = jreduced(ARCHS[name], **OVERRIDES.get(name, {}))
    tcfg = reduced(get_arch(name), **OVERRIDES.get(name, {}))
    tree = draw_params(jz.model_spec(jcfg), jcfg.use_bias)

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jp, convert.model_params_from_jax(tree, "cpu")


@functools.lru_cache(maxsize=None)
def _jitted(name, fn, mode):
    """The reference's model call ``fn`` for arch ``name`` in ``mode``, jitted."""
    jcfg = _model(name)[0]
    ctx = jl.ApplyCtx(mode=mode)
    if fn == "forward_train":
        return jax.jit(lambda p, batch: jz.forward_train(jcfg, p, batch, ctx=ctx)[0])
    if fn == "prefill":
        return jax.jit(lambda p, batch, c: jz.prefill(jcfg, p, batch, c, ctx=ctx))
    return jax.jit(lambda p, t, c: jz.decode_step(jcfg, p, t, c, ctx=ctx))


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _first_block(name, j):
    """Pattern position ``j``'s parameters of cycle 0, in both packages."""
    _, _, jp, tp = _model(name)
    return (jax.tree_util.tree_map(lambda a: a[0], jp["cycles"][j]),
            ttree_map(lambda a: a[0], tp["cycles"][j]))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    x, scale = _x((2, 5, 64)), 1.0 + 0.1 * _x((64,), seed=1)
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jdt), 1e-5)
    got = tl.rmsnorm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x).to(tdt), 1e-5)
    assert got.dtype == tdt  # the activation dtype, math in float32
    # bfloat16: one rounding of the same float32 value, within one ulp (2^-8)
    _close(got, want, MOD_TOL if dtype == "float32" else dict(rtol=2**-8, atol=1e-6))


def test_rope_matches_reference():
    x = _x((2, 7, 3, 16))
    pos = np.arange(5, 12)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    _close(tl.rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0), want, MOD_TOL)


@pytest.mark.parametrize("name", DENSE_FFN_NAMES)
def test_mlp_matches_reference(name):
    jcfg, tcfg, _, _ = _model(name)
    jp, tp = _first_block(name, 0)
    if tcfg.use_bias:  # drawn, not the reference's zeros
        assert float(tp["ffn"]["bi"].abs().min()) > 0 and float(tp["ffn"]["bo"].abs().min()) > 0
    x = _x((2, 5, 64))
    want = jl.mlp(jcfg, jp["ffn"], jnp.asarray(x))
    _close(tl.mlp(tcfg, tp["ffn"], torch.as_tensor(x)), want, MOD_TOL)


def _attn_case(name):
    jcfg, tcfg, _, _ = _model(name)
    j = 2 if name == "recurrentgemma-2b" else 0  # the attention position of the pattern
    jp, tp = _first_block(name, j)
    return jcfg, tcfg, jp["attn"], tp["attn"]


@pytest.mark.parametrize("name,window", [("tinyllama-1.1b", 0), ("recurrentgemma-2b", 4)])
@pytest.mark.parametrize("t", [3, 9])  # within and past the window
def test_attention_prefill_and_decode_match_reference(name, window, t):
    """Prefill t tokens, then decode 6 more, past the ring's wrap."""
    jcfg, tcfg, jp, tp = _attn_case(name)
    b, max_len = 2, 16
    x = _x((b, t + 6, 64), seed=t)
    jcache = jl.init_attention_cache(jcfg, b, max_len, jnp.float32, window=window)
    tcache = tl.init_attention_cache(tcfg, b, max_len, torch.float32, "cpu", window=window)
    want, jcache = jl.attention(jcfg, jp, jnp.asarray(x[:, :t]), ctx=jl.ApplyCtx(mode="prefill"),
                                window=window, cache=jcache)
    got, tcache = tl.attention(tcfg, tp, torch.as_tensor(x[:, :t]), ctx=tl.ApplyCtx(mode="prefill"),
                               window=window, cache=tcache)
    _close(got, want, MOD_TOL)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], MOD_TOL)
    for i in range(t, t + 6):
        length = np.int32(i)
        want, jcache = jl.attention(
            jcfg, jp, jnp.asarray(x[:, i : i + 1]), ctx=jl.ApplyCtx(mode="decode"), window=window,
            positions=jnp.full((1,), length), length=jnp.asarray(length), cache=jcache)
        got, tcache = tl.attention(
            tcfg, tp, torch.as_tensor(x[:, i : i + 1]), ctx=tl.ApplyCtx(mode="decode"),
            window=window, positions=torch.full((1,), i, dtype=torch.int32),
            length=torch.tensor(i, dtype=torch.int32), cache=tcache)
        _close(got, want, MOD_TOL)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], MOD_TOL)


def test_attention_train_matches_reference_across_query_chunks():
    """Two query chunks of 4 (the chunk rule of _full_attention) in train mode."""
    jcfg, tcfg, jp, tp = _attn_case("recurrentgemma-2b")
    x = _x((2, 8, 64), seed=5)
    want, _ = jl.attention(jcfg, jp, jnp.asarray(x), ctx=jl.ApplyCtx(mode="train", q_chunk=4), window=4)
    got, _ = tl.attention(tcfg, tp, torch.as_tensor(x), ctx=tl.ApplyCtx(mode="train", q_chunk=4), window=4)
    _close(got, want, MOD_TOL)


def test_rglru_block_prefill_and_decode_match_reference():
    jcfg, tcfg, _, _ = _model("recurrentgemma-2b")
    jp, tp = (p["mix"] for p in _first_block("recurrentgemma-2b", 0))
    b, t = 2, 7
    x = 0.5 * _x((b, t + 3, 64), seed=2)
    jcache = jr.init_rglru_cache(jcfg, b)
    tcache = tr.init_rglru_cache(tcfg, b, "cpu")
    want, jcache = jr.rglru_block(jcfg, jp, jnp.asarray(x[:, :t]), ctx=jl.ApplyCtx(mode="prefill"),
                                  cache=jcache)
    got, tcache = tr.rglru_block(tcfg, tp, torch.as_tensor(x[:, :t]), ctx=tl.ApplyCtx(mode="prefill"),
                                 cache=tcache)
    _close(got, want, MOD_TOL)
    for i in range(t, t + 3):
        want, jcache = jr.rglru_block(jcfg, jp, jnp.asarray(x[:, i : i + 1]),
                                      ctx=jl.ApplyCtx(mode="decode"), cache=jcache)
        got, tcache = tr.rglru_block(tcfg, tp, torch.as_tensor(x[:, i : i + 1]),
                                     ctx=tl.ApplyCtx(mode="decode"), cache=tcache)
        _close(got, want, MOD_TOL)
    for key in ("h", "conv"):
        assert tcache[key].dtype == torch.float32
        _close(tcache[key], jcache[key], MOD_TOL)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_reference(name):
    """Prefill 8 tokens (past recurrentgemma's 4-token window; after
    internvl2's 8 patches; over whisper's 16 encoded frames), then decode 4,
    against the reference's logits; also the train-mode forward."""
    jcfg, tcfg, jp, tp = _model(name)
    b, t, k = 2, 12, 8
    toks = _tokens(jcfg, b, t)
    extras = extra_inputs(jcfg, b)
    jbatch, tbatch = batches(toks, extras)
    want = _jitted(name, "forward_train", "train")(jp, jbatch)
    got, _ = tz.forward_train(tcfg, tp, tbatch, ctx=tl.ApplyCtx(mode="train"))
    assert got.shape == (b, jcfg.vision_patches + t, jcfg.vocab_size)
    _close(got, want, MODEL_TOL)

    jcache = jz.init_cache(jcfg, b, 32, jnp.float32)
    tcache = tz.init_cache(tcfg, b, 32, torch.float32, device="cpu")
    jbatch, tbatch = batches(toks[:, :k], extras)
    want, jcache = _jitted(name, "prefill", "prefill")(jp, jbatch, jcache)
    got, tcache = tz.prefill(tcfg, tp, tbatch, tcache, ctx=tl.ApplyCtx(mode="prefill"))
    _close(got, want, MODEL_TOL)
    for j in range(k, t):
        want, jcache = _jitted(name, "decode_step", "decode")(jp, jnp.asarray(toks[:, j : j + 1]), jcache)
        got, tcache = tz.decode_step(tcfg, tp, torch.as_tensor(toks[:, j : j + 1]), tcache,
                                     ctx=tl.ApplyCtx(mode="decode"))
        _close(got, want, MODEL_TOL)
    assert int(tcache["length"]) == int(jcache["length"]) == jcfg.vision_patches + t


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_generate_matches_reference_tokens(name):
    """8 greedy tokens after 6-token prompts.  The port's ``max_len`` counts
    text rows and its cache adds the vision prefix's; the reference's cache
    is ``max_len`` deep, so it is given the prefix's rows explicitly."""
    jcfg, tcfg, jp, tp = _model(name)
    toks = _tokens(jcfg, 2, 6, seed=1)
    jbatch, tbatch = batches(toks, extra_inputs(jcfg, 2, seed=1))
    want = jss.generate(jcfg, jp, jbatch, jcfg.vision_patches + 16, 8,
                        ctx_prefill=jl.ApplyCtx(mode="prefill"), ctx_decode=jl.ApplyCtx(mode="decode"))
    got = tss.generate(tcfg, tp, tbatch, 16, 8,
                       ctx_prefill=tl.ApplyCtx(mode="prefill"), ctx_decode=tl.ApplyCtx(mode="decode"))
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_matches_teacher_forcing(name):
    """The port on its own: prefill(t[:k]) + teacher-forced decode steps
    reproduce its full-sequence forward (tests/test_models.py's property,
    whose logits sit after the vision prefix), here on the port's own
    initialisation with drawn patches and frames."""
    _, tcfg, _, _ = _model(name)
    params = tz.init_model_params(tcfg, seed=3, device="cpu")
    toks = _tokens(tcfg, 2, 12, seed=2)
    extras = extra_inputs(tcfg, 2, seed=2)
    full, _ = tz.forward_train(tcfg, params, batches(toks, extras)[1], ctx=tl.ApplyCtx(mode="train"))
    off = tcfg.vision_patches
    cache = tz.init_cache(tcfg, 2, 32, torch.float32, device="cpu")
    lg, cache = tz.prefill(tcfg, params, batches(toks[:, :8], extras)[1], cache,
                           ctx=tl.ApplyCtx(mode="prefill"))
    torch.testing.assert_close(lg, full[:, off + 7], **MODEL_TOL)
    for j in range(8, 11):
        lg, cache = tz.decode_step(tcfg, params, torch.as_tensor(toks[:, j : j + 1]), cache,
                                   ctx=tl.ApplyCtx(mode="decode"))
        torch.testing.assert_close(lg, full[:, off + j], **MODEL_TOL)


def test_vision_prefix_matches_reference():
    """internvl2's embedding: the projected patches, then the scaled token
    embeddings; prefill's positions and cache length run over both."""
    from repro.models import transformer as jt
    from repro_torch.models import transformer as tt

    jcfg, tcfg, jp, tp = _model("internvl2-1b")
    toks, extras = _tokens(jcfg, 2, 5, seed=4), extra_inputs(jcfg, 2, seed=4)
    want = jt._embed(jcfg, jp, jnp.asarray(toks), jnp.asarray(extras["vision"]))
    got = tt._embed(tcfg, tp, torch.as_tensor(toks), torch.as_tensor(extras["vision"]))
    assert got.shape == (2, jcfg.vision_patches + 5, jcfg.d_model)
    _close(got, want, MOD_TOL)
    _close(got[:, :jcfg.vision_patches], extras["vision"] @ np.asarray(jp["vision_proj"]), MOD_TOL)
    cache = tz.init_cache(tcfg, 2, 16, torch.float32, device="cpu")
    tz.prefill(tcfg, tp, batches(toks, extras)[1], cache, ctx=tl.ApplyCtx(mode="prefill"))
    assert int(cache["length"]) == jcfg.vision_patches + 5
    k = cache["cycles"][0]["k"][0]  # layer 0's cache: rows of the patches and tokens, then zeros
    assert bool(k[:, : jcfg.vision_patches + 5].abs().amax(dim=(-1, -2)).gt(0).all())
    assert not bool(k[:, jcfg.vision_patches + 5 :].any())


def test_latency_demo_sizes_the_cache_for_the_vision_prefix():
    """reduced(internvl2-1b, vision_patches=64), 16-token prompts, 4 tokens:
    the reference's latency demo sizes its cache prompt + gen + 8 = 28 rows, and
    its prefill of 64 + 16 rows raises; the port's latency demo adds the
    prefix's rows and generates the reference's tokens from a cache that
    fits (the reference's generate given 92 rows)."""
    from repro_torch.launch.serve import latency_demo

    jcfg = jreduced(ARCHS["internvl2-1b"], vision_patches=64)
    tcfg = reduced(get_arch("internvl2-1b"), vision_patches=64)
    b, prompt, gen = 4, 16, 4
    tree = draw_params(jz.model_spec(jcfg), jcfg.use_bias, seed=5)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = convert.model_params_from_jax(tree, "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (b, prompt)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "vision": jnp.zeros((b, 64, jcfg.d_model))}
    with pytest.raises(ValueError, match="negative"):
        jz.prefill(jcfg, jp, jbatch, jz.init_cache(jcfg, b, prompt + gen + 8, jnp.float32),
                   ctx=jl.ApplyCtx(mode="prefill"))

    out = latency_demo(tcfg, tp, batch=b, prompt_len=prompt, gen_len=gen)
    assert out["cache"]["cycles"][0]["k"].shape[2] == 64 + prompt + gen + 8
    assert int(out["cache"]["length"]) == 64 + prompt + gen - 1
    want = jss.generate(jcfg, jp, jbatch, 64 + prompt + gen + 8, gen,
                        ctx_prefill=jl.ApplyCtx(mode="prefill"), ctx_decode=jl.ApplyCtx(mode="decode"))
    np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(want))


PART_ARGS = dict(rounds=4, replicas=3, batch=6, prompt_len=8, gen_len=3, drain_every=2,
                 drift_threshold=0.05, serve_smoke=False)


def test_token_only_serve_steps_match_reference_tokens_on_a_vision_arch():
    """Partitioned serving's model calls on reduced internvl2-1b: prefill of
    a token-only batch (no patch prefix, as the reference's launch.serve passes
    ``{"tokens": toks}``) and greedy decode steps into a cache of ``prompt_len
    + gen_len + 8`` rows give the reference's tokens."""
    jcfg, tcfg, jp, tp = _model("internvl2-1b")
    prompt, gen = PART_ARGS["prompt_len"], PART_ARGS["gen_len"]
    toks = _tokens(jcfg, 4, prompt, seed=7)
    depth = prompt + gen + 8
    jprefill = jax.jit(jss.make_prefill_step(jcfg, ctx=jl.ApplyCtx(mode="prefill")))
    jdecode = jax.jit(jss.make_decode_step(jcfg, ctx=jl.ApplyCtx(mode="decode")))
    token, jcache = jprefill(jp, {"tokens": jnp.asarray(toks)}, jz.init_cache(jcfg, 4, depth, jnp.float32))
    want = [token]
    for _ in range(gen - 1):
        token, jcache = jdecode(jp, token, jcache)
        want.append(token)
    tprefill = tss.make_prefill_step(tcfg, ctx=tl.ApplyCtx(mode="prefill"))
    tdecode = tss.make_decode_step(tcfg, ctx=tl.ApplyCtx(mode="decode"))
    cache = tz.init_cache(tcfg, 4, depth, torch.float32, device="cpu")
    token, cache = tprefill(tp, {"tokens": torch.as_tensor(toks)}, cache)
    got = [token]
    for _ in range(gen - 1):
        token, cache = tdecode(tp, token, cache)
        got.append(token)
    assert int(cache["length"]) == prompt + gen - 1  # no patch rows
    np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))


def _check_partitioned_serving_counters(name, capsys):
    """``launch.serve --arch <name> --rounds 4 --replicas 3 --batch 6
    --prompt-len 8 --gen-len 3 --drain-every 2`` (reduced) in both packages:
    round 0's requests by replica (the equal split, quantized: no random
    draw decides them), one push a round and one drain every 2 rounds, as
    the reference's launch.serve prints them; every split the port published is
    finite and sums to 1.  Later rounds' counts, the proposes and the
    makespans follow each package's own random stream (torch's generator,
    not threefry), so they are not compared."""
    import argparse
    import re

    from repro.launch import serve as jserve
    from repro_torch.launch.serve import partitioned_serving

    args = argparse.Namespace(**PART_ARGS)
    jserve._partitioned_serving(jreduced(ARCHS[name]), args)
    printed = capsys.readouterr().out
    want_round0 = [int(c) for c in re.search(r"^\s+0 \| \[([\d ]+)\]", printed, re.M)[1].split()]
    want_pushes, want_drains = map(int, re.search(r"service: (\d+) pushes, (\d+) drains",
                                                  printed).groups())

    _, tcfg, _, tp = _model(name)
    result = partitioned_serving(tcfg, tp, args)
    c = result["counters"]
    assert [int(n) for n in result["counts"][0]] == want_round0
    assert sum(want_round0) == args.batch
    assert (c["pushes"], c["drains"]) == (want_pushes, want_drains) == (
        args.rounds, args.rounds // args.drain_every)
    assert len(result["counts"]) == args.rounds
    for fr in result["published"]:
        assert np.isfinite(fr).all() and abs(float(fr.sum()) - 1.0) < 1e-5


def test_partitioned_serving_of_a_vision_arch_matches_reference_counters(capsys):
    """internvl2-1b, served on its text alone (no patch prefix)."""
    _check_partitioned_serving_counters("internvl2-1b", capsys)


def test_partitioned_serving_of_an_ssm_arch_matches_reference_counters(capsys):
    """xlstm-1.3b: attention-free, its mLSTM and sLSTM states in the cache."""
    _check_partitioned_serving_counters("xlstm-1.3b", capsys)


def test_partitioned_serving_refuses_an_encoder_decoder():
    """Partitioned serving passes token batches only; whisper-medium needs its
    frames, so it is refused before anything is served (the reference's
    launch.serve fails too, with a KeyError on 'frames')."""
    import argparse

    from repro_torch.launch.serve import partitioned_serving

    _, tcfg, _, tp = _model("whisper-medium")
    with pytest.raises(ValueError, match="frames.*latency demo"):
        partitioned_serving(tcfg, tp, argparse.Namespace(**PART_ARGS))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_full_width_param_count_matches_reference(name):
    """The full-width spec, counted without allocating (2.89 B for recurrentgemma)."""
    assert tz.param_count(get_arch(name)) == jz.param_count(ARCHS[name])
    assert get_arch(name).param_count() == jz.param_count(ARCHS[name])


def test_init_model_params_draws_each_leaf_at_its_scale():
    cfg = reduced(get_arch("recurrentgemma-2b"), dtype="bfloat16")
    params = tz.init_model_params(cfg, seed=0, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert float(params["embed"].float().std()) == pytest.approx(64**-0.5, rel=0.05)
    mix = params["cycles"][0]["mix"]
    assert mix["w_in"].shape == (1, 64, 64)  # the n_cycles axis leads
    assert torch.all(mix["lam"] == 1) and torch.all(mix["conv_b"] == 0)
    again = tz.init_model_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["embed"], params["embed"])


def test_init_params_draws_large_leaves_in_pieces(monkeypatch):
    """A leaf over params._DRAW_CHUNK elements (arctic-480b's stacked
    experts at full width) is drawn piece by piece into the leaf: the same
    scale, the model dtype, and the same values from the same seed."""
    from repro_torch.models import params as tparams

    monkeypatch.setattr(tparams, "_DRAW_CHUNK", 1000)
    cfg = reduced(get_arch("arctic-480b"), dtype="bfloat16")
    params = tz.init_model_params(cfg, seed=0, device="cpu")
    wi = params["cycles"][0]["ffn"]["wi"]
    assert wi.shape == (2, 4, 64, 128) and wi.dtype == torch.bfloat16 and wi.numel() > 1000
    assert float(wi.float().std()) == pytest.approx(0.02, rel=0.05)
    assert torch.equal(tz.init_model_params(cfg, seed=0, device="cpu")["cycles"][0]["ffn"]["wi"], wi)


def test_unported_arch_and_kind_raise():
    """A name and a block kind that neither package has: the registry and
    the block spec raise and name what the port has."""
    assert "mamba-2.8b" not in ARCHS
    with pytest.raises(KeyError, match="recurrentgemma-2b"):
        get_arch("mamba-2.8b")
    from repro.models import transformer as jt
    from repro_torch.models import transformer

    with pytest.raises(ValueError):
        jt.block_spec(jreduced(ARCHS["tinyllama-1.1b"]), "mamba")
    with pytest.raises(ValueError, match="not ported"):
        transformer.block_spec(reduced(get_arch("tinyllama-1.1b")), "mamba")


def test_entry_points_without_a_device_raise_on_a_cpu_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    cfg = reduced(get_arch("tinyllama-1.1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tz.init_model_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tz.init_cache(cfg, 1, 8)


def test_serve_cli_runs_reduced_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "recurrentgemma-2b",
         "--device", "cpu", "--prompt-len", "8", "--gen-len", "4"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "arch=recurrentgemma-2b-smoke batch=4 prompt=8" in proc.stdout
    assert "generated token ids (seq 0):" in proc.stdout
    # partitioned serving (--rounds) runs too since the service is ported
    rounds = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--rounds", "2",
                             "--drain-every", "1", "--device", "cpu", "--prompt-len", "8",
                             "--gen-len", "2"], capture_output=True, text=True, timeout=300)
    assert rounds.returncode == 0, rounds.stderr
    assert "service: 2 pushes, 2 drains" in rounds.stdout and "oracle makespan" in rounds.stdout


@pytest.mark.cuda
def test_serving_on_card_goes_through_both_kernels():
    """Reduced recurrentgemma on the card: prefill launches K3 once per RG-LRU
    layer, each decode step K2 once per attention layer, and the logits match
    the same model on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, tcfg, _, tp = _model("recurrentgemma-2b")
    params = ttree_map(lambda a: a.cuda(), tp)
    toks = torch.as_tensor(_tokens(tcfg, 2, 12))
    cache = tz.init_cache(tcfg, 2, 32, torch.float32, device="cuda")
    cpu_cache = tz.init_cache(tcfg, 2, 32, torch.float32, device="cpu")
    kernels.reset_launch_counts()
    got, cache = tz.prefill(tcfg, params, {"tokens": toks[:, :8].cuda()}, cache,
                            ctx=tl.ApplyCtx(mode="prefill"))
    want, cpu_cache = tz.prefill(tcfg, tp, {"tokens": toks[:, :8]}, cpu_cache, ctx=tl.ApplyCtx(mode="prefill"))
    _close(got.cpu(), want, MODEL_TOL)
    for j in range(8, 11):
        got, cache = tz.decode_step(tcfg, params, toks[:, j : j + 1].cuda(), cache,
                                    ctx=tl.ApplyCtx(mode="decode"))
        want, cpu_cache = tz.decode_step(tcfg, tp, toks[:, j : j + 1], cpu_cache,
                                         ctx=tl.ApplyCtx(mode="decode"))
        _close(got.cpu(), want, MODEL_TOL)
    counts = kernels.launch_counts()
    assert counts["lru_scan"] == 4 and counts["decode_attention"] == 3
