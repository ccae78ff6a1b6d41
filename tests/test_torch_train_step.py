"""The port's train step (``repro_torch.train.train_step``) against the
reference's, on the CPU in float32 at reduced width.

Weights are drawn with numpy along the reference's spec
(``test_torch_models.draw_params``) and cross over through
``convert.model_params_from_jax``; tokens, labels (some masked), frames and
patches are numpy draws handed to both packages.  The reference's calls are
jitted.

Tolerances, float32:

* losses and their parts at rtol 1e-5 (a sum of a few hundred float32
  terms; the two packages measured 0 to 2e-6 apart);
* a gradient leaf within 1e-5 of its largest entry (per leaf:
  |got - want| <= 1e-5 max|want| + 1e-8; measured up to 1.3e-6, through up
  to eight layers of backward in two summation orders);
* after AdamW updates, parameters within ``PARAM_ATOL`` (below), moments m
  and v, which are linear in the gradients and their squares, at the
  gradients' tolerance.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as jreduced
from repro.configs.base import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.distributed.compression import make_compressor as jmake_compressor
from repro.models import layers as jl
from repro.models import model_zoo as jz
from repro.optim import adamw as ja
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs import RunConfig, ShapeConfig, get_arch, reduced
from repro_torch.distributed.compression import make_compressor
from repro_torch.models import layers as tl
from repro_torch.models.params import leaves
from repro_torch.train import train_step as tts
from test_torch_models import draw_params, extra_inputs

LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
# One family per case: dense, MoE at capacity factor 0.5 (48 (token, slot)
# pairs of 24 tokens for 4 x 6 slots: at least half dropped), hybrid (its scan
# through LruScan: lru_scan_plain forward and lru_scan_backward_plain on the
# CPU, K3 and its backward on the card), encdec with frames, vision with
# patches, ssm.
FAMILIES = {"tinyllama-1.1b": {}, "granite-moe-3b-a800m": dict(capacity_factor=0.5),
            "recurrentgemma-2b": dict(local_window=4), "whisper-medium": {},
            "internvl2-1b": {}, "xlstm-1.3b": {}}
B, T = 2, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the suite's worker processes would oversubscribe
    the cores (tests/test_torch_dag.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def model(name, **over):
    """(reference config, port config, numpy weights) of a reduced arch,
    with ``over`` on top of its family's overrides."""
    over = {**FAMILIES.get(name, {}), **over}
    jcfg = jreduced(ARCHS[name], **over)
    tcfg = reduced(get_arch(name), **over)
    return jcfg, tcfg, draw_params(jz.model_spec(jcfg), jcfg.use_bias)


def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tparams(tree):
    return convert.model_params_from_jax(tree, "cpu")


def batch(cfg, b=B, t=T, seed=0, lead=()):
    """Tokens, labels (the first three of row 0 masked) and the family's
    frames or patches; ``lead`` prepends a microbatch axis."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (*lead, b, t)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (*lead, b, t)).astype(np.int32)
    labels[..., 0, :3] = -1
    out = dict(tokens=tokens, labels=labels)
    for k, v in extra_inputs(cfg, int(np.prod(lead or (1,))) * b, seed).items():
        out[k] = v.reshape(*lead, b, *v.shape[1:])
    return out


def both(np_batch):
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.as_tensor(v) for k, v in np_batch.items()})


def assert_grads(got, want):
    want = jax.tree_util.tree_leaves(want)
    got = leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        err = np.abs(g.float().numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + 1e-8, (tuple(g.shape), err, np.abs(w).max())


def test_cross_entropy_with_masked_labels_matches_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(3, 5, 17))).astype(np.float32)
    labels = rng.integers(0, 17, (3, 5)).astype(np.int32)
    labels[0] = -1  # a row of masked positions
    labels[1, 2] = -1
    for lab in (labels, np.full_like(labels, -1)):  # all masked: the denominator's floor
        want = jts.cross_entropy(jnp.asarray(logits), jnp.asarray(lab), 17)
        got = tts.cross_entropy(torch.as_tensor(logits), torch.as_tensor(lab), 17)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_and_microbatch_gradients_match_reference(name):
    jcfg, tcfg, tree = model(name)
    jb, tb = both(batch(tcfg))
    want_loss, want_m = jts.loss_fn(jcfg, jparams(tree), jb, jl.ApplyCtx(mode="train"))
    (loss, metrics), grads = tts.microbatch_value_and_grad(tcfg, tl.ApplyCtx(mode="train"))(
        tparams(tree), tb)
    (_, _), want = jax.jit(jts.microbatch_value_and_grad(jcfg, jl.ApplyCtx(mode="train")))(
        jparams(tree), jb)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for k in ("xent", "aux", "z"):
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]), rtol=LOSS_RTOL, atol=1e-7)
    if tcfg.num_experts:
        assert float(metrics["aux"]) > 0  # the load-balance loss in train mode
    assert not loss.requires_grad and all(not g.requires_grad for g in leaves(grads))
    assert_grads(grads, want)


REMAT_ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m", "recurrentgemma-2b")


@functools.lru_cache(maxsize=None)
def _remat_run(name, remat):
    _, tcfg, tree = model(name)
    _, tb = both(batch(tcfg))
    return tts.microbatch_value_and_grad(tcfg, tl.ApplyCtx(mode="train", remat=remat))(
        tparams(tree), tb)


@pytest.mark.parametrize("name", REMAT_ARCHS)
@pytest.mark.parametrize("remat", ["full", "dots", "outs"])
def test_remat_gives_the_loss_and_gradients_of_none(remat, name):
    """Each setting recomputes or keeps the same operations' results: the
    loss and every gradient bitwise "none"'s."""
    (l0, _), g0 = _remat_run(name, "none")
    (l1, _), g1 = _remat_run(name, remat)
    assert float(l0) == float(l1)
    assert len(leaves(g0)) == len(leaves(g1))
    for a, b in zip(leaves(g0), leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_an_unknown_remat_raises():
    _, tcfg, tree = model("tinyllama-1.1b")
    _, tb = both(batch(tcfg))
    with pytest.raises(ValueError, match=re.escape("'some': none | full | dots | outs")):
        tts.microbatch_value_and_grad(tcfg, tl.ApplyCtx(mode="train", remat="some"))(
            tparams(tree), tb)


@pytest.mark.parametrize("remat", ["dots", "outs"])
def test_saving_policies_match_the_reference_gradients(remat):
    jcfg, tcfg, tree = model("recurrentgemma-2b")
    jb, tb = both(batch(tcfg))
    (loss, _), got = _remat_run("recurrentgemma-2b", remat)
    (want_loss, _), want = jax.jit(jts.microbatch_value_and_grad(
        jcfg, jl.ApplyCtx(mode="train", remat=remat)))(jparams(tree), jb)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert_grads(got, want)


def _reference_cycle(name, remat, **over):
    """What the reference's checkpointed cycle holds: the ``dot_general``s
    with no batch dimension, and the names of its ``checkpoint_name``s."""
    jcfg, tcfg, tree = model(name, **over)
    jb, _ = both(batch(tcfg))
    ctx = jl.ApplyCtx(mode="train", remat=remat)
    closed = jax.make_jaxpr(lambda p: jts.loss_fn(jcfg, p, jb, ctx))(jparams(tree))
    found = dict(cycles=0, dots=0, names=[])

    def walk(jaxpr, inside):
        for eqn in jaxpr.eqns:
            remat = eqn.primitive.name in ("checkpoint", "remat2")  # jax.checkpoint's
            here = inside or remat
            found["cycles"] += remat
            if here and eqn.primitive.name == "dot_general":
                (_, _), (batch_l, _) = eqn.params["dimension_numbers"]
                found["dots"] += not batch_l
            if here and eqn.primitive.name == "name":
                found["names"].append(eqn.params["name"])
            for value in eqn.params.values():
                for sub in value if isinstance(value, (list, tuple)) else [value]:
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        walk(sub, here)

    walk(closed.jaxpr, False)
    assert found["cycles"] == 1  # the scan's body, traced once
    return found


def _saved_a_cycle(name, remat, monkeypatch, **over):
    """How many results the port's policy keeps over one cycle of the
    reduced arch's microbatch (its forward, not the recompute), with the
    weights in the model's dtype, as a trainer holds them."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models import model_zoo, transformer

    saved = []
    policy = transformer.remat_policy

    def counting(which, weights):
        inner = policy(which, weights)

        def count(ctx, op, *args, **kwargs):
            decision = inner(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and decision == CheckpointPolicy.MUST_SAVE:
                saved.append(op)
            return decision

        return count

    monkeypatch.setattr(transformer, "remat_policy", counting)
    _, tcfg, _ = model(name, **over)
    _, tb = both(batch(tcfg))
    params = model_zoo.init_model_params(tcfg, seed=0, device="cpu")
    tts.microbatch_value_and_grad(tcfg, tl.ApplyCtx(mode="train", remat=remat))(params, tb)
    n_cycles = tcfg.num_layers // len(tcfg.pattern)
    assert len(saved) % n_cycles == 0
    return len(saved) // n_cycles, saved


@pytest.mark.parametrize("name, dtype", [(name, "float32") for name in REMAT_ARCHS]
                         + [("granite-moe-3b-a800m", "bfloat16")])
def test_dots_saves_the_products_the_reference_saves(name, dtype, monkeypatch):
    """As many products a cycle as the reference's cycle has dot_generals
    with no batch dimension: the weight products (7 a dense layer; the MoE
    layer's router but not its per-expert products; 8 an RG-LRU layer).
    In bfloat16 the router's product is on its weight cast to float32
    inside the cycle, a tensor that is no parameter: it is kept all the
    same, as the reference keeps it."""
    n, saved = _saved_a_cycle(name, "dots", monkeypatch, dtype=dtype)
    assert n == _reference_cycle(name, "dots", dtype=dtype)["dots"]
    assert n == {"tinyllama-1.1b": 7, "granite-moe-3b-a800m": 5, "recurrentgemma-2b": 23}[name]
    assert set(saved) <= {torch.ops.aten.mm.default, torch.ops.aten.bmm.default}


@pytest.mark.parametrize("name", REMAT_ARCHS)
def test_outs_saves_exactly_the_named_outputs(name, monkeypatch):
    """The tensors the reference names in its cycle: an attention layer's
    output and an FFN's, two a dense or MoE layer, one an RG-LRU layer."""
    from repro_torch.models.transformer import MIXERS

    n, saved = _saved_a_cycle(name, "outs", monkeypatch)
    names = _reference_cycle(name, "outs")["names"]
    _, tcfg, _ = model(name)
    assert n == len(names) == sum((kind not in MIXERS) + 1 for kind in tcfg.pattern)
    assert set(saved) == {torch.ops.repro_torch.checkpoint_name.default}


# The PyTorch operations (TorchDispatchMode) of reduced archs from
# ``init_model_params(seed=0)`` at a (2, 12) batch: a microbatch's forward
# and backward under "none" and "full", a prefill of 8 tokens and one decode
# step after it, as the port dispatched them before "dots" and "outs"
# existed (torch 2.13.0, the CPU), with K2, K3 and K3's backward one custom
# op a call (the plain versions' operations counted before).  The names add
# nothing outside "outs".
DISPATCHED = {"tinyllama-1.1b": dict(none=879, full=1335, prefill=399, decode=313),
              "granite-moe-3b-a800m": dict(none=1178, full=1854, prefill=559, decode=473),
              "recurrentgemma-2b": dict(none=1074, full=1666, prefill=408, decode=369)}


@pytest.mark.parametrize("name", REMAT_ARCHS)
def test_decode_and_none_and_full_dispatch_the_operations_they_did(name):
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import model_zoo
    from repro_torch.train import serve_step

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    cfg = reduced(get_arch(name))
    params = model_zoo.init_model_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tb = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12), generator=gen),
          "labels": torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)}
    got = {}
    for remat in ("none", "full"):
        vg = tts.microbatch_value_and_grad(cfg, tl.ApplyCtx(mode="train", remat=remat))
        with Count() as count:
            vg(params, tb)
        got[remat] = count.ops
    prefill = serve_step.make_prefill_step(cfg, ctx=tl.ApplyCtx(mode="prefill"))
    decode = serve_step.make_decode_step(cfg, ctx=tl.ApplyCtx(mode="decode"))
    cache = model_zoo.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    with Count() as count:
        token, cache = prefill(params, {"tokens": tb["tokens"][:, :8]}, cache)
    got["prefill"] = count.ops
    with Count() as count:
        decode(params, token, cache)
    got["decode"] = count.ops
    assert {k: len(v) for k, v in got.items()} == DISPATCHED[name]
    assert all(torch.ops.repro_torch.checkpoint_name.default not in v for v in got.values())


def test_split_microbatches_matches_reference():
    _, tcfg, _ = model("internvl2-1b")
    np_b = batch(tcfg, b=6)
    want = jts.split_microbatches({k: jnp.asarray(v) for k, v in np_b.items()}, 3)
    got = tts.split_microbatches({k: torch.as_tensor(v) for k, v in np_b.items()}, 3)
    for k in np_b:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="not divisible"):
        tts.split_microbatches({"tokens": torch.zeros(5, 2)}, 3)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "granite-moe-3b-a800m"])
def test_accumulate_grads_with_a_zero_weight_matches_reference(name):
    jcfg, tcfg, tree = model(name)
    jb, tb = both(batch(tcfg, b=2, lead=(3,)))
    w = np.asarray([0.5, 0.0, 2.0], np.float32)
    want, want_m = jts.accumulate_grads(jcfg, jparams(tree), jb, ctx=jl.ApplyCtx(mode="train"),
                                        num_microbatches=3, weights=jnp.asarray(w))
    got, got_m = tts.accumulate_grads(tcfg, tparams(tree), tb, ctx=tl.ApplyCtx(mode="train"),
                                      num_microbatches=3, weights=torch.as_tensor(w))
    assert_grads(got, want)
    for k in ("loss", "xent", "aux", "z"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=LOSS_RTOL, atol=1e-7)
    # the zero-weight microbatch counts in the unweighted means only
    single = [tts.microbatch_value_and_grad(tcfg, tl.ApplyCtx(mode="train"))(
        tparams(tree), {k: v[i] for k, v in tb.items()})[0][0] for i in (0, 2)]
    np.testing.assert_allclose(float(got_m["loss"]), float((0.5 * single[0] + 2.0 * single[1]) / 2.5),
                               rtol=LOSS_RTOL)


# After an update, AdamW moves each parameter by lr x m_hat / (sqrt(v_hat) +
# eps) ~ lr x sign(g) at the first count wherever |g| >> eps.  An entry whose
# gradient is within rounding of 0 (|g| ~ 1e-9 here) can move by up to 2 lr in
# one package against the other.  The learning rates over the three steps
# sum to 3e-3 (warmup 2 at 2e-3: lr 0, 1e-3, 2e-3), so a parameter is held
# within 2 x 3e-3 of the reference's, and the mean over a leaf within 1e-6
# (a handful of such entries, if any, in each leaf).
PARAM_ATOL, PARAM_MEAN_ATOL = 6e-3, 1e-6
STEPS = 3
B1, B2 = 0.9, 0.95  # adamw.apply's defaults


def assert_compressed_state(tst, jst, tef, jef, kind, unclip):
    """m, v and the error feedback after a compressed step.  S, a leaf's
    gradient scale, is sqrt(max v_hat) of the reference: v_hat is a weighted
    mean of the squared clipped compressed gradients, each weight >= 0.05 x
    0.95^2 / c2 >= 0.31 at count 3, so every clipped compressed entry so far
    is <= 1.8 S, and an unclipped one <= 1.8 S x ``unclip`` (the largest
    grad_norm / grad_clip so far, at least 1).  Error feedback is a
    difference of unclipped gradients, held at the gradients' tolerance of
    S x unclip.  int8 rounds g / q (q = max|g + ef| / 127) to an integer:
    where g / q lies within float32 noise of a half-integer the two packages
    round it to neighbours, and that entry's compressed gradient differs by
    exactly one q.  Such entries are allowed, at most 1 % of a leaf's
    (measured: at most 5 of 8192), each within what one q can move over
    three steps: 2 S / 127 in m (0.1 x 3 x 1.8 S / 127 clipped), S^2 / 127
    in v (0.05 x 3 x (2 x 1.8^2 S^2 / 127 + a square of q)) and 2 S unclip /
    127 in the error feedback."""
    c2 = 1.0 - B2 ** int(jst.count)
    triples = zip(leaves(tst.m), leaves(tst.v), leaves(tef), jax.tree_util.tree_leaves(jst.m),
                  jax.tree_util.tree_leaves(jst.v), jax.tree_util.tree_leaves(jef))
    for tm, tv, te, jm, jv, je in triples:
        S = float(np.sqrt(np.max(np.asarray(jv)) / c2))
        for got, want, noise, flip in ((tm, jm, np.abs(np.asarray(jm)).max(), 2 * S / 127),
                                       (tv, jv, np.asarray(jv).max(), S * S / 127),
                                       (te, je, S * unclip, 2 * S * unclip / 127)):
            d = np.abs(got.numpy() - np.asarray(want))
            off = d > GRAD_REL * noise + 1e-8
            if kind == "int8_ef":
                assert off.sum() <= 0.01 * d.size and (d[off] <= flip).all(), (
                    tuple(d.shape), int(off.sum()), d.max(), flip)
            else:
                assert not off.any(), (tuple(d.shape), int(off.sum()), d.max(), noise)


@pytest.mark.parametrize("compression", ["none", "int8_ef", "topk_ef"])
def test_three_train_steps_match_the_reference_jitted_step(compression):
    """Three steps of reduced granite (the MoE family, tokens dropped) under
    remat "full", from the same parameters and moments (``convert``); a step
    with lr 0 first, so the updates of steps 2 and 3 are compared.  Without
    compression the port runs its own three steps.  With it, each step
    starts from the reference's parameters, moments and error feedback: an
    int8 entry rounded to the neighbouring integer (see
    ``assert_compressed_state``) moves its parameter by up to 2 lr, and with
    it every later gradient by more than float32 noise."""
    name = "granite-moe-3b-a800m"
    jcfg, tcfg, tree = model(name)
    m = 2
    shape = dict(name="t", seq_len=T, global_batch=2 * m, kind="train")
    kw = dict(learning_rate=2e-3, warmup_steps=2, total_steps=10, grad_compression=compression)
    jrun = JRunConfig(model=jcfg, shape=JShape(**shape), **kw)
    trun = RunConfig(model=tcfg, shape=ShapeConfig(**shape), **kw)
    jcomp = tcomp = None
    if compression != "none":
        jcomp, jinit = jmake_compressor(compression, None)
        tcomp, tinit = make_compressor(compression, None)
    jstep = jax.jit(jts.make_train_step(jcfg, jrun, ctx=jl.ApplyCtx(mode="train", remat="full"),
                                        num_microbatches=m, compression=jcomp))
    tstep = tts.make_train_step(tcfg, trun, ctx=tl.ApplyCtx(mode="train", remat="full"),
                                num_microbatches=m, compression=tcomp)
    jp, tp = jparams(tree), tparams(tree)
    jst = ja.init(jp)
    tst = convert.adamw_state_from_jax(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    w = np.ones(m, np.float32)
    if compression != "none":
        jef, tef = jinit(jp), tinit(tp)
    unclip = 1.0
    for step in range(STEPS):
        jb, tb = both(batch(tcfg, b=2, lead=(m,), seed=step))
        if compression == "none":
            jp, jst, jmet = jstep(jp, jst, jb, jnp.asarray(step), jnp.asarray(w))
            tp, tst, tmet = tstep(tp, tst, tb, step, torch.as_tensor(w))
        else:
            host = lambda t: jax.tree_util.tree_map(np.asarray, t)
            tp, tef = tparams(host(jp)), tparams(host(jef))
            tst = convert.adamw_state_from_jax(host(jst), "cpu")
            jp, jst, jmet, jef = jstep(jp, jst, jb, jnp.asarray(step), jnp.asarray(w), jef)
            tp, tst, tmet, tef = tstep(tp, tst, tb, step, torch.as_tensor(w), tef)
        for k in ("loss", "xent", "aux", "z", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"step {step} {k}")
        assert int(tst.count) == int(jst.count) == step + 1
        if compression == "none":
            assert_grads(tst.m, jst.m)
            assert_grads(tst.v, jst.v)
        else:
            unclip = max(unclip, float(jmet["grad_norm"]) / trun.grad_clip)
            assert_compressed_state(tst, jst, tef, jef, compression, unclip)
        for g, x in zip(leaves(tp), jax.tree_util.tree_leaves(jp)):
            d = np.abs(g.numpy() - np.asarray(x))
            assert d.max() <= PARAM_ATOL and d.mean() <= PARAM_MEAN_ATOL, (step, d.max(), d.mean())


@pytest.mark.cuda
def test_hybrid_microbatch_on_the_card_matches_the_cpu():
    """The reduced hybrid family's microbatch on the card, its RG-LRU scans
    through K3 and K3's backward (``LruScan``), against the CPU's
    (``lru_scan_plain`` and ``lru_scan_backward_plain``) from the same numpy
    weights, float32 with TF32 off: the loss at LOSS_RTOL, each gradient
    leaf within GRAD_REL of its largest entry.  Under remat "full" each
    RG-LRU layer launches K3 twice (the forward and its recompute) and the
    backward once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.models.transformer import layer_kinds

    _, tcfg, tree = model("recurrentgemma-2b")
    _, tb = both(batch(tcfg))
    ctx = tl.ApplyCtx(mode="train", remat="full")
    (want_loss, _), want = tts.microbatch_value_and_grad(tcfg, ctx)(tparams(tree), tb)
    before = kernels.launch_counts()
    (loss, _), got = tts.microbatch_value_and_grad(tcfg, ctx)(
        convert.model_params_from_jax(tree, "cuda"), {k: v.cuda() for k, v in tb.items()})
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    n = layer_kinds(tcfg).count("rglru")
    assert n == 2
    assert after["lru_scan"] - before["lru_scan"] == 2 * n
    assert after["lru_scan_bwd"] - before["lru_scan_bwd"] == n
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert len(leaves(got)) == len(leaves(want))
    for g, w in zip(leaves(got), leaves(want)):
        assert g.is_cuda and g.shape == w.shape
        err = float((g.cpu() - w).abs().max())
        assert err <= GRAD_REL * float(w.abs().max()) + 1e-8, (tuple(w.shape), err)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["dots", "outs"])
def test_saving_policies_on_the_card_give_none_and_recompute_the_scan(remat):
    """The reduced hybrid microbatch on the card under "dots" and "outs":
    the loss and gradients bitwise the card's under "none"; K3 is
    recomputed as under "full" (the policy recomputes its custom op), so
    each RG-LRU layer launches it twice and its backward once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.models.transformer import layer_kinds

    _, tcfg, tree = model("recurrentgemma-2b")
    _, tb = both(batch(tcfg))
    params = convert.model_params_from_jax(tree, "cuda")
    tb = {k: v.cuda() for k, v in tb.items()}
    (want_loss, _), want = tts.microbatch_value_and_grad(tcfg, tl.ApplyCtx(mode="train"))(params, tb)
    before = kernels.launch_counts()
    (loss, _), got = tts.microbatch_value_and_grad(
        tcfg, tl.ApplyCtx(mode="train", remat=remat))(params, tb)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    n = layer_kinds(tcfg).count("rglru")
    assert after["lru_scan"] - before["lru_scan"] == 2 * n
    assert after["lru_scan_bwd"] - before["lru_scan_bwd"] == n
    assert float(loss) == float(want_loss)
    for g, w in zip(leaves(got), leaves(want)):
        assert torch.equal(g, w), tuple(w.shape)
