"""K2 (flash-decode attention) and K3 (linear-recurrence scan): the port's
wrappers against the reference's Pallas kernels, run in interpret mode on
the CPU exactly as tests/test_kernels.py runs them, at its cases.

On a CPU tensor each wrapper runs its plain PyTorch version and no launch is
counted; on a CUDA tensor it launches the hand-written kernel or raises.  The
tests that need the card compare each kernel with its plain version there
and skip elsewhere.  Tolerances are tests/test_kernels.py's: 2e-5 (float32)
or 2e-2 (bfloat16) for K2, 1e-5 or 4e-2 for K3, 1e-5 for the empty tail, the
empty cache and the continuation.  K2 is compiled for fixed (G, D) pairs
(``INSTANTIATED``); the wrapper refuses any other before launching.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.lru_scan import lru_scan_pallas
from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    INSTANTIATED,
    decode_attention_cuda,
    decode_attention_plain,
)
from repro_torch.kernels import lru_scan as k3
from repro_torch.kernels.lru_scan import lru_scan_cuda, lru_scan_plain, scan_layout

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DECODE_CASES = [(2, 8, 2, 64, 300), (1, 4, 4, 32, 128), (3, 9, 3, 16, 1000)]
SCAN_CASES = [(2, 64, 128, 16), (1, 100, 300, 32), (3, 17, 64, 128)]
SCAN_PATH = (4, 4096, 2560)  # the serving path's prefill: recurrentgemma-2b, batch 4


def _ragged_scans():
    """K3's (B, T, R) at the edges of its tiling's chunk C: one step, a
    chunk less one, a chunk and one step, a last chunk of one step at the
    path's width, R of 64 (a part tile) and 300 (not a whole tile)."""
    c = k3.CHUNK
    return [(1, 1, 2560), (2, c - 1, 300), (2, c + 1, 2560), (4, 4097, 2560), (3, 17, 64)]


def _both(x, dtype):
    """One numpy array as a JAX array and a tensor of the same dtype."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.as_tensor(x).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _decode_inputs(b, h, kvh, d, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    return q, k, v, rng.integers(1, s + 1, (b,)).astype(np.int32)


def _scan_inputs(b, t, r, seed, near_one=False):
    """a = sigmoid(N(0, 1)), or with ``near_one`` a in [0.9, 0.9999) as the
    RG-LRU's decays are: there a chunk's product of a stays far above
    float32's rounding, so a carry that drops it shows."""
    rng = np.random.default_rng(seed)
    if near_one:
        a = (0.9 + 0.0999 * rng.uniform(size=(b, t, r))).astype(np.float32)
    else:
        a = (1.0 / (1.0 + np.exp(-rng.normal(size=(b, t, r))))).astype(np.float32)
    return a, rng.normal(size=(b, t, r)).astype(np.float32), rng.normal(size=(b, r)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,d,s", DECODE_CASES)
def test_decode_attention_matches_pallas(b, h, kvh, d, s, dtype):
    q, k, v, length = _decode_inputs(b, h, kvh, d, s, seed=b + h + s)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(length), block_s=128, interpret=True)
    before = kernels.launch_counts()
    got = ops.decode_attention(tq, tk, tv, torch.as_tensor(length))
    assert got.dtype == tq.dtype and got.shape == (b, h, d)
    _close(got, want, 2e-5 if dtype == "float32" else 2e-2)
    assert kernels.launch_counts() == before  # a CPU tensor takes the plain version


def test_decode_attention_empty_tail_matches_pallas():
    """Fill far below capacity: rows past length must not contribute."""
    q, k, v, _ = _decode_inputs(2, 4, 1, 32, 2048, seed=0)
    length = np.asarray([5, 17], np.int32)
    want = decode_attention_pallas(*map(jnp.asarray, (q, k, v, length)), block_s=256,
                                   interpret=True)
    _close(ops.decode_attention(*map(torch.as_tensor, (q, k, v, length))), want, 1e-5)


@pytest.mark.parametrize("lengths", [[0, 5], [0, 0], [16, 0]])
def test_decode_attention_empty_cache_matches_reference(lengths):
    """A sequence of length 0 gives zeros, as the JAX package's
    ``ops.decode_attention`` (interpret-mode Pallas, acc / max(l, 1e-30));
    every other sequence's result is unchanged."""
    q, k, v, _ = _decode_inputs(2, 4, 2, 32, 16, seed=5)
    length = np.asarray(lengths, np.int32)
    want = jops.decode_attention(*map(jnp.asarray, (q, k, v, length)))
    got = ops.decode_attention(*map(torch.as_tensor, (q, k, v, length)))
    assert torch.isfinite(got).all()
    _close(got, want, 1e-5)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not got[i].any()


def test_decode_attention_default_length_is_the_whole_cache():
    q, k, v, _ = _decode_inputs(2, 6, 2, 16, 40, seed=3)
    want = ref.decode_attention_ref(*map(jnp.asarray, (q, k, v)))
    _close(ops.decode_attention(*map(torch.as_tensor, (q, k, v))), want, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,r,bt", SCAN_CASES)
def test_lru_scan_matches_pallas(b, t, r, bt, dtype):
    (ja, ta), (jx, tx), (jh, th) = (_both(x, dtype) for x in _scan_inputs(b, t, r, seed=b * t + r))
    want = lru_scan_pallas(ja, jx, jh, block_t=bt, interpret=True)
    before = kernels.launch_counts()
    got = ops.lru_scan(ta, tx, th)
    assert got.dtype == ta.dtype and got.shape == (b, t, r)
    _close(got, want, 1e-5 if dtype == "float32" else 4e-2)
    assert kernels.launch_counts() == before


def test_lru_scan_continuation_matches_single_pass():
    """[0:k] then [k:] from the carried state == one pass (the prefill ->
    decode state hand-off), and both match the Pallas kernel."""
    a, x, _ = (torch.as_tensor(y) for y in _scan_inputs(2, 48, 64, seed=0))
    h0 = torch.zeros((2, 64))
    full = ops.lru_scan(a, x, h0)
    first = ops.lru_scan(a[:, :20], x[:, :20], h0)
    second = ops.lru_scan(a[:, 20:], x[:, 20:], first[:, -1])
    torch.testing.assert_close(second, full[:, 20:], rtol=1e-5, atol=1e-5)
    _close(full, lru_scan_pallas(jnp.asarray(a), jnp.asarray(x), jnp.zeros((2, 64)),
                                 block_t=16, interpret=True), 1e-5)


def test_lru_scan_default_h0_is_zero():
    a, x, _ = (torch.as_tensor(y) for y in _scan_inputs(2, 9, 5, seed=4))
    torch.testing.assert_close(ops.lru_scan(a, x), ops.lru_scan(a, x, torch.zeros((2, 5))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,r", [(1, 1, 300), (2, 127, 300), (2, 129, 64), (3, 17, 64)])
def test_lru_scan_plain_matches_pallas_near_unit_decay(b, t, r, dtype):
    """The plain version, which the on-card checks hold K3 against, agrees
    with the reference's kernel where decays near 1 carry the state far
    across chunks."""
    inputs = _scan_inputs(b, t, r, seed=t + r, near_one=True)
    (ja, ta), (jx, tx), (jh, th) = (_both(x, dtype) for x in inputs)
    want = lru_scan_pallas(ja, jx, jh, block_t=16, interpret=True)
    _close(lru_scan_plain(ta, tx, th), want, 1e-5 if dtype == "float32" else 4e-2)


@pytest.mark.parametrize("near_one", [False, True])
def test_lru_scan_near_unit_decay_shows_a_dropped_carry(near_one):
    """The on-card checks can only catch a chained carry that drops A * h_in
    (publishing the chunk's local end state H alone) where a chunk's decay A
    stays above float32's rounding: with a = sigmoid(N(0, 1)) it underflows
    over a chunk of CHUNK steps and the broken carry agrees with the plain
    version; with decays near 1 it misses by far more than 1e-5."""
    a, x, h0 = (torch.as_tensor(y)
                for y in _scan_inputs(2, 3 * k3.CHUNK + 1, 64, seed=5, near_one=near_one))
    h_in, outs = h0, []
    for t0 in range(0, a.shape[1], k3.CHUNK):
        seg = slice(t0, t0 + k3.CHUNK)
        outs.append(lru_scan_plain(a[:, seg], x[:, seg], h_in))
        h_in = lru_scan_plain(a[:, seg], x[:, seg], torch.zeros_like(h0))[:, -1]  # H alone
    err = float((torch.cat(outs, dim=1) - lru_scan_plain(a, x, h0)).abs().max())
    if near_one:
        assert err > 1e-3
    else:
        assert err < 1e-5


@pytest.mark.parametrize("case", range(6))
def test_lru_scan_layout_at_ragged_shapes(case):
    """K3's tiling: every (t, r) of a sequence in exactly one tile, one
    block per tile, and an 8-byte carry for every (chunk but the last, b, r)
    after the counter in the workspace."""
    bsz, t, r = (_ragged_scans() + [SCAN_PATH])[case]
    lay = scan_layout(bsz, t, r)
    assert (lay.n_chunks - 1) * k3.CHUNK < t <= lay.n_chunks * k3.CHUNK
    assert (lay.n_rtiles - 1) * k3.WIDTH < r <= lay.n_rtiles * k3.WIDTH
    assert lay.n_tiles == lay.n_chunks * bsz * lay.n_rtiles
    assert lay.workspace_bytes == 16 + 8 * (lay.n_chunks - 1) * bsz * r
    if (bsz, t, r) == SCAN_PATH:
        assert (lay.n_chunks, lay.n_rtiles, lay.n_tiles) == (32, 80, 10240)
        assert lay.workspace_bytes == 16 + 8 * 31 * 4 * 2560


def test_lru_scan_cpu_path_takes_no_layout_workspace_or_launch(monkeypatch):
    """A CPU tensor runs the plain version: no layout is computed, no
    workspace allocated and no kernel launched."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the kernel's wrapper")

    monkeypatch.setattr(k3, "scan_layout", refuse)
    monkeypatch.setattr(k3, "lru_scan_cuda", refuse)
    monkeypatch.setattr(k3._KERNEL, "launch", refuse)
    a, x, h0 = map(torch.as_tensor, _scan_inputs(*SCAN_CASES[1][:3], seed=1))
    before = kernels.launch_counts()
    _close(ops.lru_scan(a, x, h0), lru_scan_plain(a, x, h0).numpy(), 0)
    assert kernels.launch_counts() == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel paths never fall back: handed CPU tensors, they raise."""
    q, k, v, length = map(torch.as_tensor, _decode_inputs(1, 4, 1, 16, 8, seed=1))
    with pytest.raises(ValueError, match="one CUDA device"):
        decode_attention_cuda(q, k, v, length)
    a, x, h0 = map(torch.as_tensor, _scan_inputs(1, 4, 8, seed=1))
    with pytest.raises(ValueError):
        lru_scan_cuda(a, x, h0)


@pytest.mark.parametrize("b,h,kvh,d,s", [(1, 5, 1, 48, 8), (2, 6, 2, 256, 8), (1, 10, 1, 128, 8)])
def test_decode_attention_cuda_refuses_uninstantiated_group_and_head_dim(b, h, kvh, d, s):
    """K2 is compiled for fixed (G, D) pairs; any other is refused by the
    wrapper's shape check, which comes before the device check and any launch."""
    assert (h // kvh, d) not in INSTANTIATED
    q, k, v, length = map(torch.as_tensor, _decode_inputs(b, h, kvh, d, s, seed=2))
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="no instantiation"):
        decode_attention_cuda(q, k, v, length)
    assert kernels.launch_counts() == before


def test_every_parity_shape_and_config_is_instantiated():
    """The (G, D) pairs of tests/test_kernels.py's shapes (the cases, the
    empty tail) and of every ported configuration, at full width and
    reduced, have a kernel instantiation, and the wrapper's list is the CUDA
    source's."""
    import re

    from repro_torch.configs import ARCHS, get_arch, reduced
    from repro_torch.kernels.build import CSRC

    shapes = DECODE_CASES + [(2, 4, 1, 32, 2048)]
    pairs = {(h // kvh, d) for _, h, kvh, d, _ in shapes}
    pair = lambda cfg: (cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim)
    for name in ARCHS:
        pairs.add(pair(reduced(get_arch(name))))
        pairs.add(pair(get_arch(name)))
    assert pairs <= INSTANTIATED, pairs - INSTANTIATED
    source = (CSRC / "decode_attention.cu").read_text()
    compiled = {(int(g), int(d)) for g, d in re.findall(r"^\s*DECODE_CASE\((\d+), (\d+)\)", source, re.M)}
    assert compiled == INSTANTIATED


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_kernel_matches_plain_on_card(dtype):
    _needs_card()
    tdt = DTYPES[dtype][1]
    for i, case in enumerate(DECODE_CASES + [(4, 10, 1, 256, 2048)]):
        dev = lambda x: torch.as_tensor(x, device="cuda")
        q, k, v, length = (dev(x) for x in _decode_inputs(*case, seed=i))
        q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
        before = kernels.launch_counts()["decode_attention"]
        got = ops.decode_attention(q, k, v, length)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["decode_attention"] == before + 1
        _close(got.cpu(), decode_attention_plain(q, k, v, length).cpu(),
               2e-5 if dtype == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                              ("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("g,d", sorted(INSTANTIATED))
def test_decode_attention_instantiation_matches_plain_on_card(g, d, q_dtype, kv_dtype):
    """Each compiled (G, D) pair in each pair of types, with lengths 0, one
    chunk's tail, and the whole cache (two kv heads, S = 200)."""
    _needs_card()
    b, kvh, s = 3, 2, 200
    dev = lambda x: torch.as_tensor(x, device="cuda")
    q, k, v, _ = (dev(x) for x in _decode_inputs(b, g * kvh, kvh, d, s, seed=g * d))
    q, k, v = q.to(DTYPES[q_dtype][1]), k.to(DTYPES[kv_dtype][1]), v.to(DTYPES[kv_dtype][1])
    length = dev(np.asarray([0, 70, s], np.int32))
    before = kernels.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == before + 1
    assert not got[0].float().any()
    tol = 2e-5 if q_dtype == kv_dtype == "float32" else 2e-2
    _close(got.cpu(), decode_attention_plain(q, k, v, length).cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lru_scan_kernel_matches_plain_on_card(dtype):
    _needs_card()
    tdt = DTYPES[dtype][1]
    shapes = [(*case[:3], False) for case in SCAN_CASES] + [(*SCAN_PATH, False)]
    shapes += [(*shape, False) for shape in _ragged_scans()]
    shapes += [(*SCAN_PATH, True), (4, 4097, 2560, True)]  # decays near 1: the carry shows
    for b, t, r, near_one in shapes:
        a, x, h0 = (torch.as_tensor(y, device="cuda").to(tdt)
                    for y in _scan_inputs(b, t, r, seed=t, near_one=near_one))
        before = kernels.launch_counts()["lru_scan"]
        got = ops.lru_scan(a, x, h0)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["lru_scan"] == before + 1
        _close(got.cpu(), lru_scan_plain(a, x, h0).cpu(), 1e-5 if dtype == "float32" else 4e-2)


@pytest.mark.cuda
def test_lru_scan_kernel_is_bitwise_repeatable_on_card():
    """The chained carry reads only its predecessor's inclusive state, so
    two calls on the same inputs give the same bits."""
    _needs_card()
    a, x, h0 = (torch.as_tensor(y, device="cuda") for y in _scan_inputs(*SCAN_PATH, seed=11))
    first = ops.lru_scan(a, x, h0)
    second = ops.lru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_lru_scan_graph_replay_matches_eager_on_card():
    """A CUDA graph of one K3 call, replayed several times, gives the eager
    call's bits: the workspace is cleared on the stream by every replay."""
    _needs_card()
    a, x, h0 = (torch.as_tensor(y, device="cuda") for y in _scan_inputs(*SCAN_PATH, seed=12))
    eager = ops.lru_scan(a, x, h0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.lru_scan(a, x, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.lru_scan(a, x, h0)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager)
