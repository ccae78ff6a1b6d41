"""A run's check on the CPU at a cut size: a sound run is correct, and the
control and the faults a cell can have are not.

Each test drives the rest of a run past the harness's look for a card
(``conftest.run_tiny``) with the timed path broken underneath.  The fault of
the exchange between chips has no place here: every cell runs on one chip.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from conftest import run_tiny, tiny_cell
from perfbench import harness

FLEET = ("fleet-100k.every-drain", "fleet-100k.gated")
ALL = FLEET + ("yi-9b.code",)


@pytest.mark.parametrize("workload", ALL)
def test_a_sound_run_is_correct(tiny_bench, workload):
    res = run_tiny(tiny_bench, workload)
    assert res["error"] is None, res["error"]
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("workload", ALL)
def test_the_control_reads_above_the_program(tiny_bench, workload):
    """The reference one precision below the configuration's, in the
    program's place: the fleet's bfloat16 fails the cell's own limits at any
    size; the served model's fp8 weights read a token gap well above the
    program's (at this width the gaps are far below the full width's, where
    the chip readings in PERF.md set the limit between the two)."""
    cell = tiny_cell(tiny_bench, workload)
    torch.set_num_threads(1)
    seed = 2**31 + 77
    rec = harness.Record(1.0, False, torch.device("cpu"), time.perf_counter())
    samples = cell.driver.run(rec, cell.cfg, cell.mix, seed, torch.device("cpu"))
    program = cell.driver.check(samples, cell.cfg, cell.mix, seed)
    control = cell.driver.check(samples, cell.cfg, cell.mix, seed, control=True)
    assert harness.judge(program, cell.limits)[0], program
    assert not harness.judge(control, cell.limits)[0], control
    if workload not in FLEET:
        assert control["token_gap"] > 3 * program["token_gap"], (program, control)


def _fault(monkeypatch, target, name, make):
    monkeypatch.setattr(target, name, make(getattr(target, name)))


@pytest.mark.parametrize("workload", FLEET)
def test_a_tick_that_leaves_its_state_unchanged_fails(tiny_bench, workload, monkeypatch):
    from repro_torch.sched import scheduler
    from repro_torch.serve import service  # imported first: it binds advance_fleet

    def make(orig):
        return lambda fleet, times, *a, **k: (fleet, torch.zeros(times.shape[0]))
    _fault(monkeypatch, scheduler, "advance_fleet", make)
    monkeypatch.setattr(service, "advance_fleet", scheduler.advance_fleet)
    assert not run_tiny(tiny_bench, workload)["correct"]


@pytest.mark.parametrize("workload", FLEET)
def test_half_of_the_batch_left_out_fails(tiny_bench, workload, monkeypatch):
    from repro_torch.serve import service

    def make(orig):
        def drain(ring):
            batch, ring = orig(ring)
            half = batch.mask.clone()
            half[:, : half.shape[1] // 2] = 0
            return batch._replace(mask=half), ring
        return drain
    _fault(monkeypatch, service, "drain", make)
    assert not run_tiny(tiny_bench, workload)["correct"]


@pytest.mark.parametrize("workload", FLEET)
def test_an_altered_split_fails(tiny_bench, workload, monkeypatch):
    from repro_torch.serve import service

    def make(orig):
        def publish(self, fractions):
            fr = fractions.clone()
            fr[int(torch.argmax(fr))] *= 0.5
            return orig(self, fr / fr.sum())
        return publish
    _fault(monkeypatch, service.ServiceLoop, "_publish", make)
    assert not run_tiny(tiny_bench, workload)["correct"]


@pytest.mark.parametrize("workload", FLEET)
def test_a_solve_that_skips_its_steps_fails(tiny_bench, workload, monkeypatch):
    """The publish-grade solve without its Adam steps publishes the better of
    its analytic candidates, with statistics true to that split."""
    from repro_torch.serve import service

    def make(orig):
        return lambda params, **kw: orig(params, **{**kw, "steps": 0})
    _fault(monkeypatch, service, "solve_fractions", make)
    res = run_tiny(tiny_bench, workload)
    assert res["error"] is None, res["error"]
    assert not res["correct"] and res["checks"]["frontier_gap"]["value"] == 0, res["checks"]


@pytest.mark.parametrize("workload", FLEET)
def test_altered_counts_fail(tiny_bench, workload, monkeypatch):
    from repro_torch import sched

    def make(orig):
        def quantize(fr, total, params=None, **kw):
            """One microbatch moved from the fastest worker to the slowest."""
            counts = orig(fr, total, params, **kw).copy()
            counts[0] -= 1
            counts[-1] += 1
            return counts
        return quantize
    _fault(monkeypatch, sched, "quantize_fractions", make)
    res = run_tiny(tiny_bench, workload)
    assert not res["correct"], res["checks"]


def test_a_decode_step_that_leaves_its_state_unchanged_fails(tiny_bench, monkeypatch):
    from repro_torch.models import model_zoo

    def make(orig):
        def decode_step(cfg, params, token, cache, *, ctx):
            logits = torch.full((token.shape[0], cfg.vocab_size), -1.0)
            return logits.scatter(1, token.long(), 1.0), cache
        return decode_step
    _fault(monkeypatch, model_zoo, "decode_step", make)
    assert not run_tiny(tiny_bench, "yi-9b.code")["correct"]


def test_half_of_the_prefill_batch_left_out_fails(tiny_bench, monkeypatch):
    from repro_torch.models import model_zoo

    def make(orig):
        def prefill(cfg, params, batch, cache, *, ctx):
            logits, cache = orig(cfg, params, batch, cache, ctx=ctx)
            half = (logits.shape[0] + 1) // 2
            return torch.cat([logits[:half], logits[:1].expand(logits.shape[0] - half, -1)]), cache
        return prefill
    _fault(monkeypatch, model_zoo, "prefill", make)
    assert not run_tiny(tiny_bench, "yi-9b.code", seconds=2.0)["correct"]


def test_an_altered_token_fails(tiny_bench, monkeypatch):
    from repro_torch.train import serve_step

    def make(orig):
        return lambda logits: (orig(logits) + 1) % logits.shape[-1]
    _fault(monkeypatch, serve_step, "greedy", make)
    assert not run_tiny(tiny_bench, "yi-9b.code")["correct"]
