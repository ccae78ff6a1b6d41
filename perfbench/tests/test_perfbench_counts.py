"""The operation, byte and FLOP counts at known shapes."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import TINY_CONFIGS, ROOT
from perfbench import harness
from perfbench.counts import dense_lm, k1, k2
from perfbench.drivers.serve import make_weights, model_config
from perfbench.reference import llama


def test_k1_at_the_kernel_timing_shape():
    ops, nbytes = k1.work(4096, 256, 256)
    assert ops == 9 * 4096 * 256 * 256 == 2_415_919_104
    assert nbytes == 4 * (3 * 4096 * 256 + 8 * 4096 + 256 + 2 * 4096 * 256)
    assert k1.bound_s(4096, 256, 256) == pytest.approx(3.6058e-5, rel=1e-4)  # operations
    assert k1.work(4096, 256, 256, mirrored=False)[0] == 10 * 4096 * 256 * 256


def test_k1_at_the_fleet_drain_is_bytes_bound():
    ops, nbytes = k1.work(100_000, 8, 512)
    assert nbytes / k1.HBM > ops / k1.F32_FLOPS
    assert k1.bound_s(100_000, 8, 512) == pytest.approx(nbytes / 3.35e12)


def test_k2_at_the_yi_decode_shape_matches_the_kernels_own_count():
    from repro_torch.kernels import decode_attention as kda

    ops, nbytes = k2.work(4, 32, 4, 128, 536)
    assert nbytes == 8_847_376 and ops == 4 * 4 * 32 * 536 * 128
    meta = lambda *s, dt: torch.empty(s, dtype=dt, device="meta")
    q = meta(4, 32, 128, dt=torch.bfloat16)
    kv = meta(4, 536, 4, 128, dt=torch.float32)
    assert kda.work(q, kv, kv, meta(4, dt=torch.int32)) == (ops, nbytes)
    assert k2.bound_s(4, 32, 4, 128, 536) == pytest.approx(2.6410e-6, rel=1e-4)


@pytest.mark.parametrize("prior", [0, 5])
def test_dense_lm_flops_count_every_product_of_one_token(prior):
    """One new token after ``prior`` rows: the count equals the products the
    plain forward runs for its last position (attention over prior + 1 rows)."""
    cfg = dict(harness.load_json(ROOT / "perfbench/configs/yi-9b.json"), **TINY_CONFIGS["yi-9b"])
    params = make_weights(model_config(cfg), 0, "cpu")
    toks = torch.randint(0, cfg["vocab_size"], (2, prior + 1))
    with FlopCounterMode(display=False) as fc:
        llama.logits_at(params, toks, cfg, torch.tensor([prior]))
    # the plain forward projects every position and attends each to all
    # rows: take away what the positions before the last cost
    lin = 2 * cfg["num_hidden_layers"] * dense_lm.linear_params(cfg)
    d, h, t = cfg["hidden_size"], cfg["num_attention_heads"], prior + 1
    attn = 4 * cfg["num_hidden_layers"] * h * (d // h)
    extra = 2 * (prior * lin + attn * (t * t - t))
    assert fc.get_total_flops() - extra == dense_lm.flops(cfg, 2, 1, prior)
