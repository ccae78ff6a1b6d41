#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before the
result lines:

  1. environment: the card's name and power limit, torch and CUDA versions,
     TF32 off;
  2. build: every CUDA kernel of the port (K1 posterior grid, K2 decode
     attention, K3 linear-recurrence scan and its backward, two entry points
     of one source), from ``src/repro_torch/kernels/csrc``, into
     ``build/kernels`` (one ``nvcc`` per source, all started together), with
     ptxas's registers and spills of every entry function;
  3. each kernel against its plain PyTorch version on the card, at odd
     shapes, at the reference kernel tests' shapes and at the shapes the main
     paths give it: K1 in both its modes (mirrored and general), the
     service's slab (2048, 512, 8) and dense drain (100 000, 512, 8) among
     them, K2 at every compiled (G, D), with a sequence of length 0 and at
     the decode shapes of phases 7b-7h and 7j (arctic's (7, 128), whisper's
     self and 1500-row cross caches at (1, 64), internvl2's (7, 64), yi's and
     command-r's (8, 128), tinyllama's (8, 64)) in float32 and with a
     bfloat16 query, K3 at the ragged edges
     of its tiling, with decays near 1 (where every chunk's carry shows) and
     from rows that are not 16-byte aligned, and K3's output bitwise the
     same on two calls and on replays of a CUDA graph; then K3's backward
     (``lru_scan_bwd`` through ``LruScan``) against ``torch.autograd.grad``
     through the plain version with the same dy, at those cases in both
     types and at the training path's (2, 512, 2560), h0 != 0, each case
     synchronised under a host-side timeout, and two calls bitwise equal;
  4. each kernel's device time at its main path's shape (median of
     CUDA-event-timed replays of a CUDA graph of repeated calls), its plain
     version's time, its bound, for K1 the general mode's time and the
     special-function floor, for K2 the time of
     ``scaled_dot_product_attention`` on the same inputs (also at the
     decode shapes of phases 7d-7g and 7j, whisper's cross cache among them,
     under ``by_shape``, each with its share of the bound), and for K3 the
     stream yardstick ``torch.add(a, x, out=h)``, which moves its bytes, and
     its time from rows that are not 16-byte aligned (plain loads, not TMA),
     and its time at the training path's (2, 512, 2560); K3's backward at
     (2, 512, 2560) and, under ``by_shape``, at the prefill shape, each
     against its byte bound (a, dy and h read, da and db written);
  5. the paper's two-unit quickstart on the card: parameter recovery and f*
     per objective;
  6. the fleet cycle, slice 1's main path: K = 4096 heterogeneous workers, 3
     cycles of observe (N = 256) -> propose -> quantize (8 K microbatches),
     observe and propose under ``torch.cuda.set_sync_debug_mode("error")``;
     K1 launches (3 x 20, mirrored mode), finite fractions summing to 1, counts summing to
     the total, and the share of the oracle's gain over the uniform split that
     the learned split recovers (>= 80 %);
  7. serving, slice 2's main path: recurrentgemma-2b at full width (bf16
     parameters from seed 0) through ``repro_torch.launch.serve.latency_demo``,
     batch 4, 4096-token random prompts, 32 greedy tokens, float32 cache;
     prefill and decode times, peak device memory, K3 launches (18, one per
     RG-LRU layer of the prefill), K2 launches (8 x 31, one per attention
     layer of each decode step) and finite logits;
  8. teacher forcing at full width: the same model in float32, prefill of
     2100 tokens (past the 2048-token window) and 3 teacher-forced decode
     steps against ``forward_train``'s logits (rtol 2e-2, atol 2e-3, as
     tests/test_models.py);
  9. the always-on service at fleet scale, slice 5's main path (K = 100 000,
     G = 512, ring 8, 20 sweeps, active set M = 2048): (a) the active path
     at arange(K) bitwise the dense path (K = 4096, ``gibbs_batch`` and
     ``advance_fleet``), (b) K1's slab launch bitwise the dense launch and
     rows outside the index untouched, (c) ``select_active`` against a
     stable sort on the host, (d) every worker refreshed within ceil(K/M)
     ticks (K = 8192, M = 512), and the hierarchical, calibrated-gate
     service's ticks with no sync before the flag read, (e) dense and active ``ServiceLoop`` ticks
     with async propose, every advance under sync-debug "error", 20 K1
     launches a tick, no drops, flat device memory, with tick times, the
     async dispatch's host time, dispatch to publish and peak memory beside
     ``compression_report``, (f) a capacity state of 2 x 4096 slots through
     admit -> observe -> propose -> retire with no sync, dead slots getting
     exactly 0 of the proposal and of the quantized microbatches;
 7b. smollm-135m at full width through ``python -m repro_torch.launch.serve``
     with SMOLLM_ARGV (batch 4, 512-token prompts, 16 tokens), after a
     2-token warm-up: K2 launches (30 per decode step, (G, D) = (3, 64)),
     tokens in range, finite logits;
 7c. the MoE family: granite-moe-3b-a800m at full width (32 layers, 40
     experts top-8, 3.3 B bf16 parameters) through the same entry point
     with GRANITE_ARGV, as 7b: K2 launches (32 per decode step at (3, 64)),
     tokens in range, finite logits, prefill and decode times, peak memory;
     then its cycle-0 MoE layer in float32 on 2048 tokens at the config's
     capacity factor (tokens dropped) on the card against the CPU, expert
     ids, positions and keep mask bitwise; and its teacher forcing at full
     width in float32 with the capacity factor at E/k (dropless), as phase 8;
 7d. arctic-480b at full width (128 experts top-2 beside a dense residual
     FFN, head dim 128) with its depth cut to 2 of 35 layers (27.2 GB of
     bf16 weights a layer) through the same entry point with ARCTIC_ARGV:
     one prefill of 4 x 128 tokens and 3 decode steps, K2 launches (2 per
     decode step at (7, 128)), peak memory;
 7e. the encoder-decoder family: whisper-medium at full width (24 encoder
     layers over 1500 zero frames, 24 decoder layers with cross attention)
     through the same entry point with WHISPER_ARGV (batch 4, 64-token
     prompts, 16 tokens), after a 2-token warm-up: K2 launches (2 per
     decoder layer and decode step, (G, D) = (1, 64): the self cache and
     the 1500-row cross cache), the encoder's own time, peak memory;
 7f. the vision family: internvl2-1b at full width (256 zero patch
     embeddings before 512-token prompts, qkv and MLP biases) with
     INTERNVL_ARGV, as 7e: K2 launches (24 per decode step at (7, 64));
 7g. yi-9b at full width (48 layers, 8.8 B bf16 parameters) with YI_ARGV
     (batch 4, 512-token prompts, 16 tokens), as 7e: K2 at (8, 128);
 7h. command-r-35b at full width and all 40 layers (30.3 B bf16
     parameters, 60.6 GB) with COMMAND_R_ARGV: one prefill of
     4 x 128 tokens and 3 decode steps, no warm-up, K2 at (8, 128), peak
     memory;
 7i. the ssm family: xlstm-1.3b at full width and depth (42 mLSTM and 6
     sLSTM layers, 1.24 B bf16 parameters) with XLSTM_ARGV (batch 4,
     512-token prompts, 16 tokens), as 7f: no K1, K2 or K3 launch (the
     family is attention-free), prefill and decode times, peak memory; then
     one sLSTM block's prefill at (4, 512, 2048) and one mLSTM block's,
     each timed apart with CUDA events, beside the whole prefill;
 7j. tinyllama-1.1b at full width (22 layers, d_model 2048, 32 heads over 4
     kv heads of 64, 1.1 B bf16 parameters) with TINYLLAMA_ARGV (batch 4,
     512-token prompts, 16 tokens), as phase 7f: K2 at (8, 64) 22 times a
     decode step, 330 in all;
 8b. teacher forcing at full width in float32, as phase 8, for whisper-medium
     (random frames) and internvl2-1b (random patches, biases drawn so that
     they count): batch 2, prefill, 3 decode steps against
     ``forward_train``'s logits after the vision prefix;
 8c. teacher forcing of xlstm-1.3b at full width in float32, as phase 8: one
     sequence, a prefill of 4096 tokens (two query chunks of the mLSTM's
     parallel form), 3 decode steps from the states both block kinds left
     in the cache; then those steps' recurrent states against the states a
     prefill of all 4099 tokens leaves (XLSTM_STATE_TOL), and two negative
     controls, decode with every mLSTM (then sLSTM) state held at its
     initial values, which TF_TOL and the state check must both fail;
 10. partitioned serving at full width: ``repro_torch.launch.serve`` with
     PART_ARGV (recurrentgemma-2b, 16 rounds, 4 replicas, batch 16, 1024-token
     prompts, 16 tokens, a drain every 4 rounds, the drift gate at the
     reference smoke's 0.12), the reference's smoke
     condition (proposes >= 1, drains > proposes), finite published splits
     summing to 1, the oracle makespans, and K1, K2 and K3 launches; then
     each kernel against its plain version at the shapes this run gave it
     (K1 at the service's (replicas, G, ring), K3 at every prefill batch
     replica 0 served, K2 at those batches over the decode steps' lengths);
 10b. partitioned serving of internvl2-1b at full width on token batches
     alone, as the reference's launch.serve serves it (fault 3d), with
     PART_VLM_ARGV (4 rounds, 4 replicas, batch 16, 512-token prompts, 8
     tokens, a drain every 2 rounds): 4 pushes and 2 drains, finite
     published splits summing to 1, K1 launches (4 a drain) and K2 (24
     layers x 7 steps x 4 rounds at (7, 64)); then K1 and K2 against their
     plain versions at the shapes this run gave them, as phase 10;
 11. the workflow DAG, slice 6's main path: 8 stages (0 -> {1, 2, 3} -> 4 ->
     {5, 6} -> 7; stage 2 conditional at p 0.3, stage 6 at 0.5, stage 3
     reworked at 0.4 up to 4 attempts, stage 5 at 0.2 up to 3, stage 7 256
     workers wide, the others K = 512: S K = 4096 estimated workers), 3
     cycles of ``observe_dag`` (N = 256) -> ``propose_dag`` (a variance
     budget of half the uniform split's) -> ``quantize_dag_fractions`` (8 K
     microbatches a stage, largest remainder), observe and propose under
     sync-debug "error";
     K1 against its plain version at the folded (8, 512, 256) block through
     the stacked entry, K1 launches (20 per ``observe_dag``), times of each
     step and of ``simulate_workflow`` at 2e5 samples, peak memory; the
     learned split against the uniform one on the simulator with common
     random numbers (asserted), the stochastic-aware against the
     deterministic-assumption split, the analytic composed moments against
     the simulator, the move refinement once (one pass, its accepted moves,
     moves run, device reads and ms a move), and
     ``examples/pipeline_dag_torch.py``'s diamond with its two assertions;
 12. ``examples/serve_partitioned_torch.py``'s body on full-width
     tinyllama-1.1b (3 replicas, 8 rounds of 24 requests, replica 0's shard
     served: 12-token prompts, 2 decode steps): each round's counts, drains
     and proposes (drains > proposes >= 1), the learned split's oracle
     makespan below the equal split's, the risk-averse split's Var no more
     than the min-mean split's, the deadline's P(t <= eps) in (0, 1]; K1 12
     times a drain, K2 22 x 2 times a round; then K1 at (3, 128, 8) and K2
     at every batch replica 0 served against their plain versions;
 13. checkpoint and resume (``repro_torch.checkpoint``), run right after
     phase 9: phase 9 (e)'s dense service at K = 100 000 with 4 rows left
     buffered is saved, restored into a fresh template on the card, and the
     restored and the saved loop tick twice on the same telemetry, every
     leaf (the generator's state included) and the published split bitwise;
     then the scheduler state alone, observe -> propose on both, bitwise;
     the bytes written and the ms of save, wait and restore.
 14. the legacy partitioner API (``repro_torch.sched.compat``) at phase 6's
     fleet (K = 4096, N = 256, its truth and telemetry, 3 cycles):
     ``HeterogeneityAwarePartitioner`` (its DeprecationWarning asserted)
     beside a ``sched.Scheduler`` twin of the same config and seed, both
     with ``min_fraction`` 1/total; ``propose_fractions`` and
     ``propose_microbatches(8 K)`` bitwise the twin's every cycle; the
     oracle gap (>= 80 %); ``optimize_fractions`` and the legacy
     ``quantize_fractions`` bitwise the functions they delegate to; the
     ``risk_aversion`` property; 120 K1 launches (20 x 3 x 2);
 15. fault tolerance (``repro_torch.distributed.fault_tolerance``) around
     phase 14's two partitioners: 8 steps of one job a worker, 41 workers
     6x slow throughout and from step 4 another 41 reporting ``inf`` to
     monitor A (finite times to B): failure masks exact, no failed worker
     flagged, straggler recall 1.0 at the last step, the live ``ewma_ll``
     bitwise B's and the failed ones frozen, false positives printed; then
     evict (K = 4055), admit 41 (K = 4096), the events in order, and one
     observe at the degraded truth + ``propose_fractions``: finite
     fractions summing to 1, every admitted worker > 0, the stragglers'
     share below what it was; 20 K1 launches;
 16. gradient compression (``repro_torch.distributed.compression``) over
     full-width tinyllama-1.1b's parameter tree (1.100 B float32 entries,
     seeded): ``int8_ef`` and ``topk_ef`` at ratio 0.01, two chained calls
     each, on every leaf sent + ef' == g + ef, int8 as integers x scale,
     top-k keeping k entries and more only by ties; three leaves (the
     embedding, the stacked q projection, the final norm's scale) on the
     card bitwise the CPU's; each call's ms, the peak memory, the int8
     payload's bytes.
 17. training (``repro_torch.train``): first three steps of
     ``make_train_step`` on the card against the CPU (reduced smollm-135m,
     granite-moe-3b and recurrentgemma-2b, whose scans run K3 and its
     backward, in float32: loss and grad norm at rtol 1e-5, m and v within
     1e-4 of each leaf's largest entry; K3 48 and its backward 24
     launches); then ``Trainer`` on full-width tinyllama-1.1b (1.100 B bf16
     parameters), RunConfig's defaults (remat "full", lr 3e-4) but batch 16
     x 512 in 8 microbatches, 32 steps, warmup 3, a drain every 16 steps
     and ``int8_ef`` compression, over ``launch/train.py``'s four simulated
     workers: step ms (median and range after 2 warm-up steps), tokens/s,
     peak memory, losses, splits, makespans; every loss finite, the last
     quarter's mean loss and makespan below the first's, a split proposed,
     40 K1 launches (20 an observe, 2 drains); one microbatch's forward and
     backward under each remat setting ("none", "full", "dots", "outs"),
     ms, memory and operations dispatched, the loss and every gradient of
     the last three bitwise those of "none"; that microbatch tiled to 8 and
     32 rows under "full", "dots" and "outs" (ms and memory; "none" would
     not fit at 32), the last two bitwise "full"'s; one more step under
     ``torch.profiler``: its host ms, its kernels' ms, the card's idle
     share, the top kernels;
 18. ``repro_torch.launch.train.main`` on full-width smollm-135m (16 steps,
     then ``--resume --steps 8`` from step 16; 20 K1 launches), then
     tests/test_system.py's exact resume at this width on ``Trainer``
     objects (8 sequences of 128 in 4 microbatches, the test's layout: 8
     steps, save, 4 more; a fresh trainer restored at 8 and 4 steps;
     losses at rtol 1e-4), the bytes written and the ms of save,
     wait and restore; then K1 against its plain version at the trainer's
     (4, 256, 32).
 19. the hybrid family trained: phase 17's ``Trainer`` on recurrentgemma-2b
     at full width with its depth cut to 12 of 26 layers (4 whole cycles,
     8 RG-LRU layers), 16 steps with a drain every 8: step ms, tokens/s,
     peak memory, the loss and makespan conditions, K3 2 x 8 x 8 = 128
     launches a step (the forward and remat's recompute) and its backward
     64, K1 40; one microbatch under each remat setting, bitwise "none"'s,
     K3 launched once an RG-LRU layer under "none" and twice under the
     others (the recompute), its backward once; a profiled step; then K1
     against its plain version at the trainer's shape;
 20. ``examples/train_hetero_torch.py``'s ``main`` at its full width
     (smollm-135m in float32, 8 x 64 tokens in 8 microbatches, four
     simulated workers), its 300 steps cut to 36 (3 refits, 3
     checkpoints): step ms (median and range after 2 warm-up steps),
     tokens/s, peak memory; finite losses, the last decile's mean loss and
     the last quarter's makespan below the first's, the slow worker the
     least loaded in the last split; K1 20 a drain, no other kernel;
     then K1 against its plain version at the trainer's (4, 256, 24);
 21. ``examples/elastic_failover_torch.py``'s ``main`` at its own settings
     (reduced tinyllama-1.1b): its asserts, a straggler event for worker 1,
     a fleet of 2, the resume at step 48, phase 5's observation counts; K1
     20 a drain and 3 an observe of phase 5, no other kernel; then K1
     against its plain version at every shape the example gave it (the
     trainers' (3, 256, 16) and (2, 256, 16), phase 5's (8, 32, 8) and
     (9, 32, 4)).
 22. the estimator's fleet sharding (``repro_torch.core.sharding``) on a
     one-rank NCCL world started in this process (a ``FileStore`` under
     ``build/``, any stale one deleted first), its mesh from
     ``ShardingConfig.auto()`` (1 shard): the host ms of one all-gather of
     four (K,) leaves at both K below and of the 13-scalar ``all_reduce``;
     phase 6's fleet (K = 4096, N = 256, 3 cycles of observe -> propose ->
     quantize) under ``SchedulerConfig(mesh=...)`` beside an unsharded
     twin from the same seed on the same telemetry, log-likelihoods, states, generators,
     fractions and counts bitwise (or within 1e-4, said which), the sharded
     observe and propose under sync-debug "error" after one warm-up
     observe, 60 K1 launches (``launches_by_path["sharded"]``), the oracle
     gap (>= 80 %); one ``observe_dag`` of phase 11's DAG (S K = 4096, 20
     K1 launches, "sharded_dag"); ``fit_hyperprior_sharded`` (rtol 1e-5),
     ``shrink`` and ``surprise`` against their unsharded forms and one
     hierarchical ``admit_workers`` on the mesh; one observe at phase 9
     (e)'s scale, K = 100 000, G 512, N 8, 20 sweeps (20 K1 launches,
     "sharded_fleet_scale"); the ms and peak memory of each observe sharded
     and unsharded.  The world is destroyed at the end of the phase.
 23. model-tensor sharding (``repro_torch.distributed.sharding`` and the
     model stack's mesh hooks) on a one-rank NCCL world and a (1, 1)
     ("data", "model") ``DeviceMesh`` (a ``FileStore`` under ``build/``):
     full-width recurrentgemma-2b, all 26 layers, its parameters placed by
     ``tree_shardings(default_rules(fsdp=False))`` and its cache by
     ``cache_shardings``, prefill of 4 x 1024 tokens and 8 decode steps (K3
     18 and K2 64 launches, every one under ``local_map``: the wrappers
     refuse a DTensor), the logits against the unsharded twin's (bitwise,
     or TF_TOL, said which), prefill and decode ms beside the twin's (each
     run once to warm up, once timed); ``Trainer(mesh_info=)`` on it cut to
     6 layers, 8 x 512 tokens in 4 microbatches, ``int8_ef`` compression, 2
     steps and one drain
     (K1 20, K3 32 and its backward 16 launches), the losses at rtol 1e-5
     of the unsharded trainer's; one full-width granite-moe-3b-a800m MoE
     layer on the mesh (its tensor-parallel path) against the unsharded
     layer; then K2's log-sum-exp output against its plain version at
     phase 7's shape and every compiled (G, D), a float32 cache split in two
     halves merged by the log-sum-exps against K2 on the whole (an empty
     half adding nothing), and K2's time at phase 7's shape with and without
     the output.  The world is destroyed at the end of the phase.
 24. the dry run (``repro_torch.launch.dryrun``): ``python -m
     repro_torch.launch.dryrun --arch tinyllama-1.1b --shape decode_32k
     --mesh single`` in a subprocess with ``--device cuda`` and with
     ``--device cpu`` (a fake world of 512 ranks, the 16 x 16 mesh on its
     first 256): each route's per-device FLOPs, bytes, collective bytes,
     peak and kernel calls, the two routes equal; then ``dryrun.cut_cell``
     of that decode step cut to 8 sequences (2.2 GB of bf16 weights, 5.9 GB
     of cache 32 768 deep) on a (1, 1) mesh, and the same step run on the
     card on a (1, 1) mesh over a one-rank NCCL world: its peak
     (``max_memory_allocated`` above what was allocated before its
     arguments) within 10 % of the estimate's ``peak_bytes_est``, its K2
     launches (22, under ``local_map``) the estimate's calls.

Then three result lines: a JSON object with every kernel's route, source,
launches on the main paths (in all, and by path), error against its plain
version, times, bound and library time; the card's name and power limit as
``nvidia-smi`` gives them; and last ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout of the repository, it fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "examples"))

# The card's published peaks (H100 SXM data sheet): float32 outside the
# tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

K_FLEET, N_OBS, GRID, SWEEPS, CYCLES = 4096, 256, 256, 20, 3
# The always-on service at fleet scale (benchmarks/bench_fleet_scale.py:60-77,
# core/compress.py's figure): K workers, grid G, active set M, ring capacity 8.
SVC_K, SVC_G, SVC_M, SVC_RING, SVC_TICKS = 100_000, 512, 2048, 8, 3
RTOL = 2e-5  # the reference kernel tests' _assert_logp_close


def say(*parts) -> None:
    print(*parts, flush=True)


def assert_logp_close(got, want, rtol=RTOL):
    """tests/test_kernels.py's bound, rtol * (1 + max|want|) + rtol * |want|,
    with the scale taken row by row: each (worker, exponent) row is
    normalised over its own grid, so it is held to its own largest
    |logp|, not to the batch's.  Returns max |err| and the largest error
    over its row's scale."""
    import torch

    scale = 1.0 + want.abs().amax(dim=-1, keepdim=True)
    err = (got - want).abs()
    bound = rtol * scale + rtol * want.abs()
    worst = float((err / scale).max())
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"kernel disagrees: max|err| {float(err.max()):.3e}, max|err| over "
                             f"its row's 1 + max|logp| {worst:.3e}, rtol {rtol:g}")
    return float(err.max()), worst


def fleet_case(k, g, n, seed, device, zero_cols=False, dead_worker=False):
    """Kernel inputs shaped as the reference kernel tests' _fleet_case."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen, device=device)
    lin = lambda a, b: torch.linspace(a, b, k, device=device)
    f = 0.05 + 0.9 * u(k, n)
    mu = lin(5.0, 40.0)
    noise = torch.randn((k, n), generator=gen, device=device)
    t = f**0.9 * mu[:, None] + f**0.7 * 2.0 * noise
    cols = torch.arange(n, device=device)
    mask = (cols[None, :] < torch.linspace(n // 2, n, k, device=device)[:, None]).float()
    if zero_cols:
        mask = mask * (cols % 5 != 0).float()[None, :]
    if dead_worker:
        mask[k // 2] = 0.0
    grid = torch.linspace(1e-4, 1 - 1e-4, g, device=device)
    return (grid, t, f, mask, mu, lin(0.1, 0.5), lin(0.6, 0.95), lin(0.5, 0.9),
            lin(1.5, 4.0), lin(2.0, 3.0), lin(2.0, 5.0), lin(1.5, 2.5))


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    """Build every kernel; print what ptxas says of each entry function
    (its name, registers, spills), as it says it."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    say(f"[build] {sorted(build.launch_counts())} built in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR.relative_to(ROOT)}")
    seen = set()
    for name in sorted(build.launch_counts()):
        report = build.ptxas_report(name)
        if report in seen:  # another entry point of a source already reported
            continue
        seen.add(report)
        for line in report.splitlines():
            if re.search(r"Compiling entry function|spill stores|Used \d+ registers", line):
                say(f"[build] {name}: {line.strip()}")


def phase_k1_parity():
    """K1 in both modes against its plain version in the same form, at odd and
    main-path shapes; the grid is a symmetric linspace, as the mirrored mode
    needs."""
    import torch
    from repro_torch.kernels.posterior_grid import posterior_grid_fleet, posterior_grid_plain

    shapes = [  # (k, g, n, zero_cols, dead_worker)
        (5, 17, 33, True, False),
        (3, 300, 777, True, True),
        (4, 512, 128, False, True),
        (1, GRID, 64, False, False),  # the quickstart's single unit, one batch
        (K_FLEET, GRID, N_OBS, False, False),  # the fleet cycle's observe
        (SVC_M, SVC_G, SVC_RING, False, False),  # the service's active slab (two 256-point passes)
        (SVC_K, SVC_G, SVC_RING, True, False),  # the service's dense drain
    ]
    worst = 0.0
    for i, ((k, g, n, zc, dead), sym) in enumerate(itertools.product(shapes, (True, False))):
        args = fleet_case(k, g, n, seed=i // 2, device="cuda", zero_cols=zc, dead_worker=dead)
        got = posterior_grid_fleet(*args, symmetric_grid=sym)
        want = posterior_grid_plain(*args, symmetric_grid=sym)
        torch.cuda.synchronize()
        err, rel = assert_logp_close(got, want)
        worst = max(worst, err)
        say(f"[k1-parity] {'mirrored' if sym else 'general '} K={k} G={g} N={n} "
            f"zero_cols={zc} dead_worker={dead}: max|err| {err:.3e} (max|logp| "
            f"{float(want.abs().max()):.3e}); max|err| over its row's 1 + max|logp| "
            f"{rel:.3e} within rtol {RTOL:g}")
    return worst


def assert_close(got, want, rtol, atol) -> float:
    """|got - want| <= atol + rtol * |want| everywhere, as
    np.testing.assert_allclose; returns max |err|."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(f"disagrees: max|err| {float(err.max()):.3e} > {atol:g} + {rtol:g} |want|")
    return float(err.max())


# K2 at the serving path's decode: recurrentgemma-2b's local attention over a
# full window (B 4, H 10, KVH 1, D 256, S 2048), bfloat16 q, float32 cache.
K2_PATH = (4, 10, 1, 256, 2048)
# K3 at the serving path's prefill: B 4, T 4096, R 2560, float32.
K3_PATH = (4, 4096, 2560)
# K3 and its backward on the training path (phase 19): a microbatch of 2 x 512
# tokens (16 x 512 in 8), R = d_model = 2560, float32 (the RG-LRU's gates).
K3_TRAIN = (2, 512, 2560)
# smollm-135m at full width (phase 7b): batch 4, 512-token prompts, 16 tokens;
# K2 at its decode, (B 4, H 9, KVH 3, D 64, S = prompt + gen + 8 cache rows).
SMOLLM_BATCH, SMOLLM_PROMPT, SMOLLM_GEN = 4, 512, 16
SMOLLM_ARGV = ["--arch", "smollm-135m", "--full", "--batch", str(SMOLLM_BATCH),
               "--prompt-len", str(SMOLLM_PROMPT), "--gen-len", str(SMOLLM_GEN)]
K2_SMOLLM = (SMOLLM_BATCH, 9, 3, 64, SMOLLM_PROMPT + SMOLLM_GEN + 8)
# granite-moe-3b-a800m at full width (phase 7c), as phase 7b: K2 at (B 4,
# H 24, KVH 8, D 64, S); its teacher forcing in float32 without drops.
GRANITE_ARCH, GRANITE_BATCH, GRANITE_PROMPT, GRANITE_GEN = "granite-moe-3b-a800m", 4, 512, 16
GRANITE_ARGV = ["--arch", GRANITE_ARCH, "--full", "--batch", str(GRANITE_BATCH),
                "--prompt-len", str(GRANITE_PROMPT), "--gen-len", str(GRANITE_GEN)]
K2_GRANITE = (GRANITE_BATCH, 24, 8, 64, GRANITE_PROMPT + GRANITE_GEN + 8)
MOE_TOKENS = 2048  # the full-width MoE layer held card against CPU
GRANITE_TF_BATCH, GRANITE_TF_PREFILL = 2, 512
# arctic-480b at full width (phase 7d) with its depth cut from 35 to
# ARCTIC_LAYERS layers (27.2 GB of bf16 weights a layer on one 80 GB card):
# one prefill, a few decode steps; K2 at (B 4, H 56, KVH 8, D 128, S).
ARCTIC_ARCH, ARCTIC_LAYERS, ARCTIC_BATCH, ARCTIC_PROMPT, ARCTIC_GEN = "arctic-480b", 2, 4, 128, 4
ARCTIC_ARGV = ["--arch", ARCTIC_ARCH, "--full", "--batch", str(ARCTIC_BATCH),
               "--prompt-len", str(ARCTIC_PROMPT), "--gen-len", str(ARCTIC_GEN)]
K2_ARCTIC = (ARCTIC_BATCH, 56, 8, 128, ARCTIC_PROMPT + ARCTIC_GEN + 8)
# Phases 7e-7h, each at full width through launch.serve's entry point:
# (arch, batch, prompt tokens, generated tokens).  The cache is vision
# patches + prompt + gen + 8 rows deep (launch/serve.py's latency_demo).
WHISPER = ("whisper-medium", 4, 64, 16)
INTERNVL = ("internvl2-1b", 4, 512, 16)
YI = ("yi-9b", 4, 512, 16)
COMMAND_R = ("command-r-35b", 4, 128, 4)  # all 40 layers: 56.4 GiB of bf16 weights


def serve_argv(arch, batch, prompt, gen):
    return ["--arch", arch, "--full", "--batch", str(batch), "--prompt-len", str(prompt),
            "--gen-len", str(gen)]


WHISPER_ARGV, INTERNVL_ARGV, YI_ARGV, COMMAND_R_ARGV = (
    serve_argv(*case) for case in (WHISPER, INTERNVL, YI, COMMAND_R))
WHISPER_FRAMES, INTERNVL_PATCHES = 1500, 256  # the configs' encoder_seq, vision_patches
# K2 at their decode shapes (B, H, KVH, D, S): whisper's self cache and its
# cross cache over every encoder row, internvl2's after its 256 patches,
# yi's and command-r's.
K2_WHISPER_SELF = (4, 16, 16, 64, WHISPER[2] + WHISPER[3] + 8)
K2_WHISPER_CROSS = (4, 16, 16, 64, WHISPER_FRAMES)
K2_INTERNVL = (4, 14, 2, 64, INTERNVL_PATCHES + INTERNVL[2] + INTERNVL[3] + 8)
K2_YI = (4, 32, 4, 128, YI[2] + YI[3] + 8)
K2_COMMAND_R = (4, 64, 8, 128, COMMAND_R[2] + COMMAND_R[3] + 8)
# Phase 7j: tinyllama-1.1b at full width (22 layers, 32 heads over 4 kv heads
# of 64), as phase 7f; K2 at (8, 64) over yi-9b's cache depth.
TINYLLAMA = ("tinyllama-1.1b", 4, 512, 16)
TINYLLAMA_ARGV = serve_argv(*TINYLLAMA)
K2_TINYLLAMA = (4, 32, 4, 64, TINYLLAMA[2] + TINYLLAMA[3] + 8)
# Phase 8b: float32 teacher forcing at full width, (arch, batch, prefill tokens).
TF_FAMILIES = (("whisper-medium", 2, 64), ("internvl2-1b", 2, 512))
# Phase 7i: the ssm family, xlstm-1.3b at full width and depth (42 mLSTM and 6
# sLSTM layers, attention-free: no kernel runs), as phase 7f.  Phase 8c: its
# float32 teacher forcing, one sequence, a prefill of two 2048-query chunks.
XLSTM = ("xlstm-1.3b", 4, 512, 16)
XLSTM_ARGV = serve_argv(*XLSTM)
XLSTM_TF_BATCH, XLSTM_TF_PREFILL = 1, 4096
# Phase 8c's recurrent states, relative to each tensor's largest value: the
# H100 measured at most 5.7e-4; a state held at its initial values is off by 0.55-1.6.
XLSTM_STATE_TOL = 5e-3
BLOCK_RUNS = 3  # CUDA-event-timed prefills of one block of each kind (median)


def decode_case(b, h, kvh, d, s, seed, q_dtype, kv_dtype, length=None):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    q, k, v = rn(b, h, d).to(q_dtype), rn(b, s, kvh, d).to(kv_dtype), rn(b, s, kvh, d).to(kv_dtype)
    if length is None:
        length = torch.randint(1, s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    else:
        length = torch.as_tensor(length, dtype=torch.int32, device="cuda")
    return q, k, v, length


def scan_case(b, t, r, seed, dtype, near_one=False):
    """a = sigmoid(N(0, 1)), or with ``near_one`` a in [0.9, 0.9999) as the
    RG-LRU's decays are: there a chunk's product of a stays far above
    float32's rounding, so a carry that drops it shows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    if near_one:
        a = 0.9 + 0.0999 * torch.rand((b, t, r), generator=gen, device="cuda")
    else:
        a = torch.sigmoid(rn(b, t, r))
    return a.to(dtype), rn(b, t, r).to(dtype), rn(b, r).to(dtype)


def phase_k2_parity():
    """K2 against its plain version: tests/test_kernels.py's shapes in both
    types, the empty tail, a sequence of length 0, one case for each compiled
    (G, D), and the serving path's shape with lengths 1 and S."""
    import torch
    from repro_torch.kernels.decode_attention import (
        INSTANTIATED,
        decode_attention,
        decode_attention_plain,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((b, h, kvh, d, s), dt, dt, None, 2e-5 if dt == f32 else 2e-2)
             for (b, h, kvh, d, s) in [(2, 8, 2, 64, 300), (1, 4, 4, 32, 128), (3, 9, 3, 16, 1000)]
             for dt in (f32, bf16)]
    cases.append(((2, 4, 1, 32, 2048), f32, f32, [5, 17], 1e-5))  # empty tail
    cases.append(((3, 8, 2, 64, 500), f32, f32, [0, 130, 500], 2e-5))  # an empty cache
    for j, (g, d) in enumerate(sorted(INSTANTIATED)):  # every instantiation, types in turn
        q_dt, kv_dt = [(f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16)][j % 4]
        cases.append(((2, 2 * g, 2, d, 300), q_dt, kv_dt, [0, 300] if j % 2 else [77, 1],
                      2e-5 if q_dt == kv_dt == f32 else 2e-2))
    s = K2_PATH[-1]
    cases.append((K2_PATH, bf16, f32, [1, s, 1000, s - 1], 2e-2))  # the serving path
    cases.append((K2_PATH, f32, f32, [1, s, 1000, s - 1], 2e-5))  # its teacher-forced check
    s = K2_SMOLLM[-1]  # phase 7b's decode: lengths from the first step to the last, and S
    cases.append((K2_SMOLLM, bf16, f32, [SMOLLM_PROMPT + 1, SMOLLM_PROMPT + SMOLLM_GEN - 1, 520, s],
                  2e-2))
    s = K2_GRANITE[-1]  # phase 7c's decode, (3, 64) at 8 kv heads
    cases.append((K2_GRANITE, bf16, f32,
                  [GRANITE_PROMPT + 1, GRANITE_PROMPT + GRANITE_GEN - 1, 520, s], 2e-2))
    s = K2_ARCTIC[-1]  # phase 7d's decode, (7, 128), and its float32 form
    for q_dt, tol in ((bf16, 2e-2), (f32, 2e-5)):
        cases.append((K2_ARCTIC, q_dt, f32,
                      [ARCTIC_PROMPT + 1, ARCTIC_PROMPT + ARCTIC_GEN - 1, ARCTIC_PROMPT + 2, s], tol))
    # Phases 7e-7h: the lengths of the first and last decode step, one
    # between, and S; whisper's cross cache every one of its 1500 rows (not a
    # multiple of the 64-row chunk).
    first_last = lambda prefix, prompt, gen, s: [prefix + prompt + 1, prefix + prompt + gen - 1,
                                                 prefix + prompt + 2, s]
    for shape, length in (
            (K2_WHISPER_CROSS, [WHISPER_FRAMES] * 4),
            (K2_WHISPER_SELF, first_last(0, *WHISPER[2:], K2_WHISPER_SELF[-1])),
            (K2_INTERNVL, first_last(INTERNVL_PATCHES, *INTERNVL[2:], K2_INTERNVL[-1])),
            (K2_YI, first_last(0, *YI[2:], K2_YI[-1])),
            (K2_COMMAND_R, first_last(0, *COMMAND_R[2:], K2_COMMAND_R[-1])),
            (K2_TINYLLAMA, first_last(0, *TINYLLAMA[2:], K2_TINYLLAMA[-1]))):
        for q_dt, tol in ((f32, 2e-5), (bf16, 1e-3)):
            cases.append((shape, q_dt, f32, length, tol))
    worst = 0.0
    for i, (shape, q_dt, kv_dt, length, tol) in enumerate(cases):
        args = decode_case(*shape, seed=100 + i, q_dtype=q_dt, kv_dtype=kv_dt, length=length)
        got = decode_attention(*args)
        want = decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = assert_close(got, want, tol, tol)
        worst = max(worst, err)
        say(f"[k2-parity] (B, H, KVH, D, S)={shape} q {q_dt} cache {kv_dt} "
            f"lengths {args[3].tolist()}: max|err| {err:.3e} within {tol:g}")
    return worst


def misaligned(x):
    """A copy of ``x`` that starts one element past a 16-byte boundary:
    K3 cannot take its rows by TMA and stages them by plain loads."""
    import torch

    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view_as(x)
    return y.copy_(x)


def phase_k3_parity():
    """K3 against its plain version: tests/test_kernels.py's shapes in both
    types, the continuation case, ragged edges of the tiling (one step, a
    chunk less or more one step, a channel tile cut short, a last chunk of
    one step) and the serving path's prefill shape, the last two also with
    decays near 1, where every chunk's carry matters, and the path's shape
    once more from rows that are not 16-byte aligned (plain loads, not TMA);
    then, at the path's
    shape, two calls on the same inputs bitwise equal, and replays of a
    CUDA graph of one call equal to the eager call (the workspace is reset
    on the stream, not by the host)."""
    import torch
    from repro_torch.kernels.lru_scan import CHUNK, lru_scan, lru_scan_plain

    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 1e-5, bf16: 4e-2}
    worst = 0.0
    cases = [((b, t, r), dt, False) for (b, t, r) in [(2, 64, 128), (1, 100, 300), (3, 17, 64)]
             for dt in (f32, bf16)]
    for dt in (f32, bf16):
        cases += [((1, 1, 2560), dt, False), ((2, CHUNK - 1, 300), dt, False),
                  ((2, CHUNK + 1, 2560), dt, False), ((4, 4097, 2560), dt, False),
                  ((4, 4097, 2560), dt, True)]
    cases += [(K3_PATH, f32, False), (K3_PATH, f32, True)]
    cases += [(K3_PATH, f32, "misaligned")]
    for i, (shape, dt, near_one) in enumerate(cases):
        a, x, h0 = scan_case(*shape, seed=200 + i, dtype=dt, near_one=bool(near_one))
        if near_one == "misaligned":
            a, x = misaligned(a), misaligned(x)
        got = lru_scan(a, x, h0)
        want = lru_scan_plain(a, x, h0)
        torch.cuda.synchronize()
        err = assert_close(got, want, tol[dt], tol[dt])
        worst = max(worst, err)
        decays = "a in [0.9, 0.9999)" if near_one else "a = sigmoid(N(0, 1))"
        if near_one == "misaligned":
            decays += ", rows not 16-byte aligned"
        say(f"[k3-parity] (B, T, R)={shape} {dt} {decays}: max|err| {err:.3e} "
            f"within {tol[dt]:g}")
    # continuation: [0:k] then [k:] from the carried state equals one pass
    a, x, _ = scan_case(2, 48, 64, seed=300, dtype=f32)
    h0 = torch.zeros((2, 64), device="cuda")
    full = lru_scan(a, x, h0)
    first = lru_scan(a[:, :20], x[:, :20], h0)
    second = lru_scan(a[:, 20:], x[:, 20:], first[:, -1])
    err = assert_close(second, full[:, 20:], 1e-5, 1e-5)
    worst = max(worst, err)
    say(f"[k3-parity] continuation (2, 48, 64) split at 20: max|err| {err:.3e} within 1e-05")
    # the chained carry rounds alike on every call, eager or replayed
    a, x, h0 = scan_case(*K3_PATH, seed=301, dtype=f32, near_one=True)
    once, again = lru_scan(a, x, h0), lru_scan(a, x, h0)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lru_scan(a, x, h0)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        replayed = lru_scan(a, x, h0)
    for replay in range(3):
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(replayed, once):
            raise AssertionError(f"K3: graph replay {replay} differs from the eager call by "
                                 f"{float((replayed - once).abs().max()):.3e}")
    if not torch.equal(once, again):
        raise AssertionError(f"K3: two calls differ by {float((once - again).abs().max()):.3e}")
    say(f"[k3-parity] (B, T, R)={K3_PATH} float32 a in [0.9, 0.9999): two calls bitwise "
        f"equal, 3 graph replays bitwise equal to the eager call")
    return worst


def sync_within(seconds: float, what: str) -> None:
    """``torch.cuda.synchronize()`` under a host-side timeout: a chained
    carry that cannot finish shows as a hang, not as a wrong number (the
    kernel's own watchdog traps after a second of waiting)."""
    import threading

    import torch

    done, failed = threading.Event(), []

    def wait():
        try:
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 — handed to the caller's thread
            failed.append(exc)
        finally:
            done.set()

    threading.Thread(target=wait, daemon=True).start()
    if not done.wait(seconds):
        raise TimeoutError(f"{what}: the card did not finish within {seconds:g} s")
    if failed:
        raise failed[0]


def scan_grads(fn, a, x, h0, dy):
    """(da, db, dh0) of ``fn(a, x, h0)`` for the upstream gradient dy."""
    import torch

    leaves = [y.detach().requires_grad_() for y in (a, x, h0)]
    return torch.autograd.grad(fn(*leaves), leaves, dy)


def phase_k3_backward_parity():
    """K3's backward (``lru_scan_bwd``, through ``LruScan``) against
    ``torch.autograd.grad`` through ``lru_scan_plain`` with the same dy, at
    phase 3's K3 cases in both types (ragged T, R of 300 and 64, a last
    chunk of one step, decays near 1, rows not 16-byte aligned), at the
    edges of the backward's own chunk (``BWD_CHUNK`` less or more one step,
    two chunks and one step) and at the training path's (2, 512, 2560), h0
    != 0 and requiring a gradient; then with h alone not 16-byte aligned
    (``lru_scan_bwd_cuda`` on the forward's output copied off the boundary,
    its da and db against ``lru_scan_backward_plain``'s; T >= 2, so the
    kernel reads h).  Each of da, db and dh0 is held
    within 1e-5 (bfloat16: 4e-2) of its largest entry: the kernel sums g in
    order and the plain version's autograd in a log-depth order, and with
    decays near 1 an entry of da near 0 is a difference of terms ~100.
    Every case synchronises under a host-side timeout; then two backward
    calls are bitwise equal.  Returns max |err|."""
    import torch
    from repro_torch.kernels.lru_scan import (BWD_CHUNK, CHUNK, lru_scan, lru_scan_backward_plain,
                                              lru_scan_bwd_cuda, lru_scan_plain)

    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 1e-5, bf16: 4e-2}
    cases = [((b, t, r), dt, False) for (b, t, r) in [(2, 64, 128), (1, 100, 300), (3, 17, 64)]
             for dt in (f32, bf16)]
    for dt in (f32, bf16):
        cases += [((1, 1, 2560), dt, False), ((2, CHUNK - 1, 300), dt, False),
                  ((2, CHUNK + 1, 2560), dt, False), ((4, 4097, 2560), dt, False),
                  ((4, 4097, 2560), dt, True), ((2, 513, 300), dt, True),
                  ((2, BWD_CHUNK - 1, 300), dt, False), ((2, BWD_CHUNK + 1, 300), dt, True),
                  ((3, 2 * BWD_CHUNK + 1, 2560), dt, True)]
    cases += [(K3_PATH, f32, True), (K3_TRAIN, f32, False), (K3_TRAIN, f32, True),
              (K3_TRAIN, f32, "misaligned"), ((2, 513, 300), bf16, "misaligned"),
              (K3_TRAIN, f32, "h misaligned"), ((2, BWD_CHUNK + 1, 2560), bf16, "h misaligned"),
              ((1, BWD_CHUNK + 1, 2560), f32, "h misaligned")]
    worst = 0.0
    for i, (shape, dt, near_one) in enumerate(cases):
        a, x, h0 = scan_case(*shape, seed=500 + i, dtype=dt, near_one=bool(near_one))
        dy = torch.randn(shape, generator=torch.Generator("cuda").manual_seed(600 + i),
                         device="cuda").to(dt)
        if near_one == "misaligned":
            a, x, dy = misaligned(a), misaligned(x), misaligned(dy)
        if near_one == "h misaligned":
            h = misaligned(lru_scan(a, x, h0))
            got = lru_scan_bwd_cuda(a, h, h0, dy)
            sync_within(60, f"K3's backward at {shape}")
            want = lru_scan_backward_plain(a, h, h0, dy)[:2]
        else:
            got = scan_grads(lru_scan, a, x, h0, dy)
            sync_within(60, f"K3's backward at {shape}")
            want = scan_grads(lru_scan_plain, a, x, h0, dy)
        rels = []
        for name, g, w in zip(("da", "db", "dh0"), got, want):
            err, scale = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
            if not bool(torch.isfinite(g).all()) or err > tol[dt] * scale:
                raise AssertionError(f"K3's backward at {shape} {dt}: {name} max|err| {err:.3e} "
                                     f"over {tol[dt]:g} x its largest entry {scale:.3e}")
            worst = max(worst, err)
            rels.append(err / scale)
        decays = "a in [0.9, 0.9999)" if near_one else "a = sigmoid(N(0, 1))"
        if near_one == "misaligned":
            decays += ", rows not 16-byte aligned"
        if near_one == "h misaligned":
            decays += ", h alone not 16-byte aligned"
        names = ", ".join(("da", "db", "dh0")[:len(rels)])
        say(f"[k3-bwd-parity] (B, T, R)={shape} {dt} {decays}: {names} max|err| over their "
            f"largest entry {', '.join(f'{x:.3e}' for x in rels)} within {tol[dt]:g}")
    a, x, h0 = scan_case(*K3_TRAIN, seed=650, dtype=f32, near_one=True)
    h = lru_scan(a, x, h0)
    dy = torch.randn(K3_TRAIN, generator=torch.Generator("cuda").manual_seed(651), device="cuda")
    once, again = lru_scan_bwd_cuda(a, h, h0, dy), lru_scan_bwd_cuda(a, h, h0, dy)
    sync_within(60, "K3's backward, repeated")
    if not all(torch.equal(u, v) for u, v in zip(once, again)):
        raise AssertionError("K3's backward: two calls on the same inputs differ")
    # the workspace is cleared on the stream: replays of a captured call agree
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lru_scan_bwd_cuda(a, h, h0, dy)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = lru_scan_bwd_cuda(a, h, h0, dy)
    for replay in range(3):
        graph.replay()
        sync_within(60, "K3's backward, replayed")
        if not all(torch.equal(u, v) for u, v in zip(replayed, once)):
            raise AssertionError(f"K3's backward: graph replay {replay} differs from the eager call")
    say(f"[k3-bwd-parity] (B, T, R)={K3_TRAIN} float32 a in [0.9, 0.9999): two calls bitwise "
        f"equal, 3 graph replays bitwise equal to the eager call")
    return worst


def time_cuda(fn, runs: int, reps: int = 10) -> float:
    """Median device milliseconds of one ``fn`` call: ``reps`` calls captured
    in a CUDA graph (after a warm-up on a side stream), the graph replayed
    ``runs`` times between CUDA events.  Replay leaves out the host's launch
    overhead, which the port's eager callers still pay (PERF.md)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(ops: float, nbytes: float, peak_ops: float):
    """The least time for ``ops`` operations and ``nbytes`` bytes: (ms, which binds)."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    return float(out[0]) * 1e6


def phase_k1_timing():
    """K1 at the fleet cycle's observe shape: the mirrored mode, which the
    Gibbs sweep runs, is the kernel's time; the general mode's is printed
    first, on a line of its own."""
    import torch
    from repro_torch.kernels.posterior_grid import posterior_grid_fleet, posterior_grid_plain

    k, g, n = K_FLEET, GRID, N_OBS
    args = fleet_case(k, g, n, seed=7, device="cuda")
    general_ms = time_cuda(lambda: posterior_grid_fleet(*args), runs=30)
    ms = time_cuda(lambda: posterior_grid_fleet(*args, symmetric_grid=True), runs=30)
    plain_ms = time_cuda(lambda: posterior_grid_plain(*args, symmetric_grid=True), runs=5, reps=3)
    # Float32 operations per (k, g, n) cell of the mirrored mode: g * log2 f,
    # the exp2, pg * pg and three fused multiply-adds (two each), 9 in all.
    # The general mode adds a reciprocal: 10.
    # Bytes: t, f, mask, the per-worker scalars and the grid read once, the
    # (K, 2, G) output written.
    ops, general_ops = 9.0 * k * g * n, 10.0 * k * g * n
    nbytes = 4.0 * (3 * k * n + 8 * k + g + 2 * k * g)
    bound_ms, bound_by = bound(ops, nbytes, PEAK_F32_FLOPS)
    general_bound_ms, general_bound_by = bound(general_ops, nbytes, PEAK_F32_FLOPS)
    # One exp2 per cell on the special-function units: 16 a clock on each SM.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    sfu_ms = k * g * n / (sms * 16 * clock) * 1e3
    say(f"[k1-time] K={k} G={g} N={n}: general mode {general_ms:.4f} ms, bound "
        f"{general_bound_ms:.4f} ms by {general_bound_by} ({general_ops:.3e} ops)")
    say(f"[k1-time] K={k} G={g} N={n}: mirrored mode {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes), "
        f"special-function floor {sfu_ms:.4f} ms ({k * g * n:.3e} exp2 on {sms} SMs x 16 "
        f"at {clock / 1e9:.3f} GHz); no single library call computes this function")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                slices=phase_k1_slices(args))


def phase_k1_slices(args):
    """K1' (``posterior_grid_pallas``): ``kernels.ops.posterior_grid_alpha``
    and ``posterior_grid_beta`` on phase 4's inputs, each held against its
    row of the plain version within K1's tolerance, then timed as phase 4
    times K1.  Each is one launch of K1's general mode, which computes both
    rows and keeps one; the bound is that of the one row the function
    returns."""
    import torch
    from repro_torch.core.moments import BetaParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.posterior_grid import posterior_grid_plain

    grid, t, f, mask, mu, lam, alpha, beta, pa_a, pa_b, pb_a, pb_b = args
    (k, n), g = t.shape, grid.shape[0]
    half, two = torch.full_like(mu, 0.5), torch.full_like(mu, 2.0)
    # Float32 operations per (k, g, n) cell of one row: g * log2 f, the
    # exp2 and pg * pg, then the alpha row's two fused multiply-adds (two
    # each), 7, or the beta row's reciprocal and one, 6.  Bytes: t, f, mask,
    # the row's five per-worker scalars and the grid read once, (K, G) written.
    nbytes = 4.0 * (3 * k * n + 5 * k + g + k * g)
    calls = dict(
        posterior_grid_alpha=(7.0, lambda: ops.posterior_grid_alpha(
            grid, t, f, mu, lam, beta, BetaParams(pa_a, pa_b), mask),
            lambda: posterior_grid_plain(grid, t, f, mask, mu, lam, half, beta, pa_a, pa_b,
                                         two, two)[:, 0]),
        posterior_grid_beta=(6.0, lambda: ops.posterior_grid_beta(
            grid, t, f, mu, lam, alpha, BetaParams(pb_a, pb_b), mask),
            lambda: posterior_grid_plain(grid, t, f, mask, mu, lam, alpha, half, two, two,
                                         pb_a, pb_b)[:, 1]),
    )
    out = {}
    for name, (ops_each, fn, plain) in calls.items():
        err, rel = assert_logp_close(fn(), plain())
        ms = time_cuda(fn, runs=30)
        plain_ms = time_cuda(plain, runs=5, reps=3)
        ops_n = ops_each * k * g * n
        bound_ms, bound_by = bound(ops_n, nbytes, PEAK_F32_FLOPS)
        say(f"[k1-time] {name} (K1', K1's general mode, both rows computed, one kept) K={k} "
            f"G={g} N={n}: max|err| {err:.3e} (over its row's 1 + max|logp| {rel:.3e}, rtol "
            f"{RTOL:g}); kernel {ms:.4f} ms ({100 * bound_ms / ms:.1f} % of its row's bound), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({ops_n:.3e} ops, "
            f"{nbytes:.3e} bytes)")
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None, max_abs_err=err)
    return out


def round_robin(fn, cases):
    """A call of ``fn`` on the next input set of ``cases``, in turn."""
    it = itertools.cycle(cases)
    return lambda: fn(*next(it))


def k2_timing(shape):
    """K2 at one decode shape, every cache row valid.  Calls take input sets
    in turn, at least four and together over 64 MB (more than the 50 MB L2), so
    the cache comes from device memory as in a decode step, where the other
    layers' weights and caches pass through L2 between two visits of one
    layer."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain

    b, h, kvh, d, s = shape
    per_set = 2 * b * s * kvh * d * 4 + 2 * b * h * d * 2  # float32 cache, bfloat16 q and out
    n_sets = max(4, -(-64_000_000 // per_set))
    cases = [decode_case(*shape, seed=7 + i, q_dtype=torch.bfloat16, kv_dtype=torch.float32,
                         length=[s] * b) for i in range(n_sets)]
    ms = time_cuda(round_robin(decode_attention, cases), runs=30, reps=20)
    plain_ms = time_cuda(round_robin(decode_attention_plain, cases), runs=30, reps=20)
    # The library yardstick: SDPA on the same q, k, v (q in the cache's type,
    # heads first) with a boolean length mask.
    sdpa_cases = [(q.float()[:, :, None, :], k.transpose(1, 2).contiguous(),
                   v.transpose(1, 2).contiguous(),
                   (torch.arange(s, device="cuda")[None, :] < n[:, None])[:, None, None, :])
                  for q, k, v, n in cases]
    sdpa = lambda q4, k4, v4, mask: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True)
    library_ms = time_cuda(round_robin(sdpa, sdpa_cases), runs=30, reps=20)
    q, k, _, length = cases[0]
    # 2 operations per multiply-add: q.k and p.v over every valid row and head
    ops = 4.0 * b * h * s * d
    nbytes = (q.numel() * 2 + 2 * k.numel() * 4 + length.numel() * 4 + q.numel() * 2)
    bound_ms, bound_by = bound(ops, nbytes, PEAK_F32_FLOPS)
    say(f"[k2-time] (B, H, KVH, D, S)={shape} ({n_sets} input sets): kernel {ms:.4f} ms "
        f"({100 * bound_ms / ms:.1f} % of the bound), plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, "
        f"{nbytes:.3e} bytes)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_k2_timing():
    """K2 at the serving path's decode shape (the kernel's time in the
    result line), and listed under ``by_shape`` at arctic-480b's (phase 7d,
    (G, D) = (7, 128)), whisper-medium's cross cache (phase 7e, (1, 64),
    1500 rows), internvl2-1b's (phase 7f, (7, 64)), yi-9b's (phase 7g,
    (8, 128)) and tinyllama-1.1b's (phase 7j, (8, 64))."""
    main_path = k2_timing(K2_PATH)
    shapes = (K2_ARCTIC, K2_WHISPER_CROSS, K2_INTERNVL, K2_YI, K2_TINYLLAMA)
    return dict(main_path, by_shape={str(shape): k2_timing(shape) for shape in shapes})


def phase_k3_timing():
    """K3 at the serving path's prefill shape, and on a line of its own the
    stream yardstick: ``torch.add(a, x, out=h)`` on the same tensors, which
    moves the same bytes (two reads, one write) with no recurrence."""
    from repro_torch.kernels.lru_scan import lru_scan, lru_scan_plain
    import torch

    b, t, r = K3_PATH
    a, x, h0 = scan_case(*K3_PATH, seed=7, dtype=torch.float32)
    ms = time_cuda(lambda: lru_scan(a, x, h0), runs=20)
    plain_ms = time_cuda(lambda: lru_scan_plain(a, x, h0), runs=5, reps=3)
    a_off, x_off = misaligned(a), misaligned(x)
    plain_loads_ms = time_cuda(lambda: lru_scan(a_off, x_off, h0), runs=20)
    h = torch.empty_like(a)
    stream_ms = time_cuda(lambda: torch.add(a, x, out=h), runs=20)
    ops = 2.0 * b * t * r  # one multiply-add per element
    nbytes = 4.0 * (3 * b * t * r + b * r)  # a, b read, h written, h0 read
    bound_ms, bound_by = bound(ops, nbytes, PEAK_F32_FLOPS)
    say(f"[k3-stream] (B, T, R)={K3_PATH} float32: torch.add(a, x, out=h) {stream_ms:.4f} ms, "
        f"{100 * bound_ms / stream_ms:.1f} % of the bound {bound_ms:.4f} ms (the same bytes, "
        f"no recurrence; a yardstick of streaming, not a library call for K3)")
    say(f"[k3-time] (B, T, R)={K3_PATH}: kernel {ms:.4f} ms ({100 * bound_ms / ms:.1f} % of the "
        f"bound), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, "
        f"{nbytes:.3e} bytes); no single library call computes a linear recurrence")
    say(f"[k3-staging] (B, T, R)={K3_PATH} float32: TMA bulk copies {ms:.4f} ms, plain loads "
        f"(rows not 16-byte aligned) {plain_loads_ms:.4f} ms")
    train = k3_timing(K3_TRAIN, scan_sets(K3_TRAIN), lambda a, x, h0, h, dy: lru_scan(a, x, h0),
                      lambda a, x, h0, h, dy: lru_scan_plain(a, x, h0), "k3-time", 2, 1, 2)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                by_shape={str(K3_TRAIN): train})


def scan_sets(shape, seed=70, n_sets=None):
    """Input sets of K3 and its backward, taken in turn: (a, b, h0, the
    forward's h, dy) in float32, by default at least four and together over
    64 MB (more than the 50 MB L2)."""
    import torch
    from repro_torch.kernels.lru_scan import lru_scan

    b, t, r = shape
    n_sets = n_sets or max(4, -(-64_000_000 // (5 * 4 * b * t * r)))
    sets = []
    for i in range(n_sets):
        a, x, h0 = scan_case(*shape, seed=seed + i, dtype=torch.float32)
        dy = torch.randn(shape, generator=torch.Generator("cuda").manual_seed(seed + 100 + i),
                         device="cuda")
        sets.append((a, x, h0, lru_scan(a, x, h0), dy))
    return sets


def k3_bound(shape, reads, writes, ops_each):
    """(ms, which binds, operations, bytes) of a K3 entry point at ``shape``
    that reads ``reads`` and writes ``writes`` (B, T, R) float32 tensors,
    reads h0 once and does ``ops_each`` operations an element."""
    b, t, r = shape
    ops = float(ops_each) * b * t * r
    nbytes = 4.0 * ((reads + writes) * b * t * r + b * r)
    return (*bound(ops, nbytes, PEAK_F32_FLOPS), ops, nbytes)


def k3_timing(shape, sets, fn, plain, tag, reads, writes, ops_each):
    """One K3 entry point at ``shape`` over ``sets``: its time, its plain
    version's and its bound: ``reads`` and ``writes`` (B, T, R) float32
    tensors and h0 read once, ``ops_each`` operations an element."""
    ms = time_cuda(round_robin(fn, sets), runs=20)
    plain_ms = time_cuda(round_robin(plain, sets), runs=5, reps=3)
    bound_ms, bound_by, ops, nbytes = k3_bound(shape, reads, writes, ops_each)
    say(f"[{tag}] (B, T, R)={shape} float32 ({len(sets)} input sets): kernel {ms:.4f} ms "
        f"({100 * bound_ms / ms:.1f} % of the bound), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({ops:.3e} ops, {nbytes:.3e} bytes)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_k3_backward_timing():
    """K3's backward at the training path's (2, 512, 2560) (the kernel's time
    in the result line) and at the serving path's prefill shape (under
    ``by_shape``): it reads a, dy and h and writes da and db, 5/3 of the
    forward's bytes.  No single library call computes a linear recurrence's
    gradient."""
    from repro_torch.kernels.lru_scan import lru_scan_backward_plain, lru_scan_bwd_cuda

    fn = lambda a, x, h0, h, dy: lru_scan_bwd_cuda(a, h, h0, dy)
    plain = lambda a, x, h0, h, dy: lru_scan_backward_plain(a, h, h0, dy)
    # 3 operations an element: g = a g + dy (a multiply-add), da = g h
    main_path = k3_timing(K3_TRAIN, scan_sets(K3_TRAIN), fn, plain, "k3-bwd-time", 3, 2, 3)
    prefill = k3_timing(K3_PATH, scan_sets(K3_PATH, n_sets=1), fn, plain, "k3-bwd-time", 3, 2, 3)
    return dict(main_path, by_shape={str(K3_PATH): prefill})


def phase_quickstart():
    import quickstart_torch as qs

    t0 = time.perf_counter()
    st_i, st_j = qs.learn("cuda")
    _, choices = qs.frontier_choices(st_i, st_j)
    # tests/test_gibbs.py's recovery thresholds
    limits = dict(mu=1.5, sigma=1.0, alpha=0.08, beta=0.15)
    for name, st in (("i", st_i), ("j", st_j)):
        learned = {p: float(getattr(st, p)) for p in limits}
        say(f"[quickstart] unit {name} learned "
            + " ".join(f"{p}={v:.3f}" for p, v in learned.items())
            + " true " + " ".join(f"{p}={qs.TRUE[name][p]}" for p in limits))
        for p, lim in limits.items():
            if not abs(learned[p] - qs.TRUE[name][p]) < lim:
                raise AssertionError(f"unit {name}: {p} not recovered within {lim}")
    for obj, f_opt, m, v in choices:
        say(f"[quickstart] objective={obj:11s} f*={f_opt:.3f} E[t]={m:.2f} Var[t]={v:.2f}")
    say(f"[quickstart] ok in {time.perf_counter() - t0:.2f} s")


def fleet_truth(device, k):
    """Phase 6's seeded fleet: the true (K,) worker parameters, and the
    generator its telemetry is drawn from after them."""
    import torch
    from repro_torch.core.frontier import UnitParams

    gen = torch.Generator(device=device).manual_seed(2015)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((k,), generator=gen, device=device)
    truth = UnitParams(mu=u(5.0, 40.0), sigma=u(0.5, 3.0), alpha=u(0.6, 0.95), beta=u(0.5, 0.9))
    return truth, gen


def fleet_times(truth, f, gen):
    """Times of jobs of sizes ``f`` ((K,) or (K, N)) drawn from the truth:
    t = f^alpha mu + f^beta sigma eps."""
    import torch

    eps = torch.randn(f.shape, generator=gen, device=f.device)
    per_k = lambda x: x.reshape(x.shape + (1,) * (f.ndim - 1))
    return (f ** per_k(truth.alpha) * per_k(truth.mu)
            + f ** per_k(truth.beta) * per_k(truth.sigma) * eps)


def fleet_telemetry(truth, fracs, gen, n):
    """Phase 6's telemetry: each worker runs n jobs whose sizes vary by
    e^[-2, 2] around its share.  Proposals move shares by up to ~16x, and
    alpha is only identified across the range the telemetry spans."""
    import torch
    from repro_torch import sched

    f = fracs[:, None] * torch.exp(
        -2.0 + 4.0 * torch.rand((fracs.shape[0], n), generator=gen, device=fracs.device))
    return sched.Telemetry(fracs=f, times=fleet_times(truth, f, gen))


def oracle_gap(truth, fracs, config):
    """The share of the oracle's gain over the uniform split that ``fracs``
    recovers under the truth, with the three scores (uniform, ``fracs``,
    oracle)."""
    import torch
    from repro_torch import sched

    k = fracs.shape[0]
    uniform = torch.full((k,), 1.0 / k, device=fracs.device)
    oracle, _ = sched.solve_fractions(
        truth, objective=config.objective, steps=config.opt_steps, lr=config.opt_lr,
        num_points=config.num_points, min_fraction=config.min_fraction)
    score = lambda fr: float(sched.evaluate(config.objective, fr, truth, num_points=config.num_points))
    s_uni, s_prop, s_orc = score(uniform), score(fracs), score(oracle)
    return (s_uni - s_prop) / max(s_uni - s_orc, 1e-12), (s_uni, s_prop, s_orc)


def phase_fleet(device="cuda", k=K_FLEET, n=N_OBS):
    """The main path: observe -> propose -> quantize on a seeded fleet.

    ``device="cpu"`` with a small ``k`` and ``n`` rehearses it without a
    card (no sync check, no device clocks)."""
    import torch
    from repro_torch import kernels, sched
    from repro_torch.device import no_sync
    from repro_torch.sched import quantize as refine

    total = 8 * k
    # The proposal floor matches quantization's one-microbatch floor.
    config = sched.SchedulerConfig(min_fraction=1.0 / total)
    truth, gen = fleet_truth(device, k)
    telemetry = lambda fracs: fleet_telemetry(truth, fracs, gen, n)

    state = sched.init(config, k, seed=0, device=device)
    fracs = torch.full((k,), 1.0 / k, device=device)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for c in range(CYCLES):
        telem = telemetry(fracs)

        def observe_and_propose():
            with no_sync(device):
                st, ll = sched.observe(state, telem, config)
                fr, stats = sched.propose(st, config)
            return st, ll, fr, stats

        (state, ll, fracs, stats), ms_cycle = clock(device, observe_and_propose)
        refine.reset_refine_stats()
        counts, ms_quant = clock(device, lambda: sched.quantize_fractions(
            fracs.cpu().numpy(), total, sched.unit_params(state), objective=config.objective))
        moves = refine.refine_stats()
        if not bool(torch.isfinite(ll).all()):
            raise AssertionError("non-finite log-likelihood")
        if not (bool(torch.isfinite(fracs).all()) and abs(float(fracs.sum()) - 1.0) < 1e-4):
            raise AssertionError(f"fractions not finite or sum {float(fracs.sum())} != 1")
        if counts.sum() != total or counts.min() < 1:
            raise AssertionError(f"counts sum {counts.sum()} != {total} or below the floor")
        say(f"[fleet] cycle {c}: observe+propose {ms_cycle:.1f} ms (sync-free), "
            f"quantize {ms_quant:.1f} ms ({moves['accepted']} moves accepted, "
            f"{moves['evaluated']} run, {moves['reads']} device reads), E[t] {float(stats.e_t):.5f}")
    launches = kernels.launch_counts()

    # Separate timings of the two device stages on the final state.
    telem = telemetry(fracs)
    _, ms_observe = clock(device, lambda: sched.observe(state, telem, config))
    _, ms_propose = clock(device, lambda: sched.propose(state, config))

    gap, (s_uni, s_prop, s_orc) = oracle_gap(truth, fracs, config)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    say(f"[fleet] K={k} N={n}: observe {ms_observe:.1f} ms, propose {ms_propose:.1f} ms, "
        f"quantize (last cycle) {ms_quant:.1f} ms, peak device memory {peak / 2**20:.1f} MiB")
    say(f"[fleet] E[t] under the truth: uniform {s_uni:.5f}, proposed {s_prop:.5f}, "
        f"oracle {s_orc:.5f}: oracle gap recovered {100 * gap:.1f} %")
    say(f"[fleet] launches on the main path: {launches}")
    return launches, gap


SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "recurrentgemma-2b", 4, 4096, 32
TF_BATCH, TF_PREFILL, TF_STEPS = 2, 2100, 3
TF_TOL = dict(rtol=2e-2, atol=2e-3)  # tests/test_models.py's decode-vs-teacher-forcing


def phase_serve():
    """Slice 2's main path: serve recurrentgemma-2b at full width."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import latency_demo
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx
    from repro_torch.models.params import leaves

    cfg = get_arch(SERVE_ARCH)
    params = model_zoo.init_model_params(cfg, seed=0)
    n_params = sum(p.numel() for p in leaves(params))
    say(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B parameters in {cfg.dtype}, "
        f"{cfg.num_layers} layers of pattern {cfg.pattern}")
    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT)
    warm = latency_demo(cfg, params, gen_len=2, **kw)  # CUDA and cuBLAS set-up, same shapes
    say(f"[serve] warm-up (prefill + 1 step): prefill {warm['prefill_ms']:.1f} ms")
    del warm
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = latency_demo(cfg, params, gen_len=SERVE_GEN, **kw)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = out["tokens"]
    # the logits of one more step on the final cache: finite and of the vocabulary's width
    logits, _ = model_zoo.decode_step(cfg, params, tokens[:, -1:], out["cache"],
                                      ctx=ApplyCtx(mode="decode"))
    if logits.shape != (SERVE_BATCH, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or misshapen")
    if tokens.shape != (SERVE_BATCH, SERVE_GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"generated tokens {tuple(tokens.shape)} out of shape or range")
    say(f"[serve] batch {SERVE_BATCH} prompt {SERVE_PROMPT} gen {SERVE_GEN}: prefill "
        f"{out['prefill_ms']:.1f} ms, decode {out['decode_ms']:.2f} ms/token, peak device "
        f"memory {peak / 2**30:.2f} GiB, logits finite")
    say(f"[serve] generated token ids (seq 0): {tokens[0].tolist()}")
    say(f"[serve] launches on the main path: {launches}")
    return launches


def teacher_forcing(cfg, params, batch, prefill, steps, tag):
    """Prefill ``prefill`` random tokens (after random patch embeddings for a
    vision model, over random frames for an encoder-decoder), then ``steps``
    teacher-forced decode steps, against ``forward_train``'s logits at the
    same positions (TF_TOL).  Returns the worst |err|."""
    import numpy as np
    import torch
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx

    total = prefill + steps
    rng = np.random.default_rng(1)
    device = params["embed"].device
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, total)),
                           dtype=torch.int32, device=device)
    extras = {}
    if cfg.vision_patches:
        extras["vision"] = torch.as_tensor(
            rng.normal(size=(batch, cfg.vision_patches, cfg.d_model)), dtype=torch.float32,
            device=device)
    if cfg.family == "encdec":
        extras["frames"] = torch.as_tensor(
            rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32,
            device=device)
    full, _ = model_zoo.forward_train(cfg, params, dict(extras, tokens=toks),
                                      ctx=ApplyCtx(mode="train"))
    off = cfg.vision_patches  # the logits of the text come after the patches
    want = full[:, off + prefill - 1:].clone()  # (B, 1 + steps, V)
    del full
    cache = model_zoo.init_cache(cfg, batch, off + total + 8, torch.float32)
    got, cache = model_zoo.prefill(cfg, params, dict(extras, tokens=toks[:, :prefill]), cache,
                                   ctx=ApplyCtx(mode="prefill"))
    outs = [got]
    for j in range(prefill, total):
        got, cache = model_zoo.decode_step(cfg, params, toks[:, j:j + 1], cache,
                                           ctx=ApplyCtx(mode="decode"))
        outs.append(got)
    return check_logits(outs, want, off + prefill - 1, tag)


def tf_used(got, want) -> float:
    """The largest share of TF_TOL that any element of |got - want| takes."""
    return float(((got.float() - want).abs()
                  / (TF_TOL["atol"] + TF_TOL["rtol"] * want.abs())).max())


def check_logits(outs, want, first, tag) -> float:
    """Step i's logits ``outs[i]`` (the prefill's, then each decode step's,
    at position ``first + i``) against ``want[:, i]`` within TF_TOL.
    Returns the worst |err|."""
    worst = 0.0
    for i, got in enumerate(outs):
        err = assert_close(got, want[:, i], **TF_TOL)
        worst = max(worst, err)
        what = "prefill" if i == 0 else f"decode step {i}"
        say(f"[{tag}] {what} (position {first + i}): max|err| {err:.3e} against "
            f"forward_train, max|logit| {float(want[:, i].abs().max()):.3f}, at most "
            f"{100 * tf_used(got, want[:, i]):.1f} % of the tolerance")
    return worst


def phase_teacher_forcing():
    """Prefill past the window, then teacher-forced decode steps, against the
    full-sequence forward, all at full width in float32."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model_zoo
    from repro_torch.models.params import tree_map

    cfg = get_arch(SERVE_ARCH)
    params = tree_map(lambda t: t.float(), model_zoo.init_model_params(cfg, seed=0))
    worst = teacher_forcing(cfg, params, TF_BATCH, TF_PREFILL, TF_STEPS, "teacher")
    say(f"[teacher] {cfg.name} float32, batch {TF_BATCH}, prefill {TF_PREFILL} > window "
        f"{cfg.local_window}, {TF_STEPS} decode steps: within rtol {TF_TOL['rtol']} "
        f"atol {TF_TOL['atol']}, worst {worst:.3e}")
    return worst


def leaves(tree):
    """The tensors of a nested NamedTuple state or tuple, in order; a
    generator as its state, a None field as nothing."""
    import torch

    if isinstance(tree, torch.Generator):
        return [tree.get_state()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    return [x for part in tree for x in leaves(part)]


def assert_bitwise(what, got, want):
    import torch

    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: leaf {i} differs (max|d| "
                                 f"{float((g.float() - w.float()).abs().max()):.3e})")


def service_config(k, *, active=None, async_propose=True, opt_steps=200, num_points=512):
    """The fleet-scale service: n_iters 20, G 512, ring 8, every data tick
    proposes (the gate never fires, staleness always does), the proposal
    floor at the one-in-8K share of phase 6, the prior centred on the truth's
    mean speed (as benchmarks/bench_fleet_scale.py)."""
    from repro_torch import sched, serve

    return serve.ServeConfig(
        sched=sched.SchedulerConfig(n_iters=SWEEPS, grid_size=SVC_G, num_points=num_points,
                                    opt_steps=opt_steps, mu_guess=1.25, min_fraction=1.0 / (8 * k)),
        capacity=SVC_RING, drift_threshold=1e9, max_staleness=1,
        active_size=active, async_propose=async_propose,
    )


def service_truth(k, device, seed):
    """mu = linspace(0.5, 2.0, K), fracs proportional to 1/mu, and a draw of
    t = f^0.9 mu + f^0.8 0.05 mu N(0, 1) per call, on the device."""
    import torch

    mu = torch.linspace(0.5, 2.0, k, device=device)
    fracs = (1.0 / mu) / torch.sum(1.0 / mu)
    gen = torch.Generator(device=device).manual_seed(seed)
    times = lambda: (fracs**0.9 * mu
                     + fracs**0.8 * 0.05 * mu * torch.randn((k,), generator=gen, device=device))
    return fracs, times


def check_active_parity(device, k):
    """(a), (b): the active path at arange(K) is the dense path bit for bit,
    and the slab launch leaves rows outside its index untouched."""
    import torch
    from repro_torch import sched
    from repro_torch.core import gibbs
    from repro_torch.core.moments import BetaParams
    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(3)
    mu = torch.linspace(0.5, 2.0, k, device=device)[:, None]
    f = 0.05 + 0.9 * torch.rand((k, SVC_RING), generator=gen, device=device)
    t = f**0.9 * mu + f**0.8 * 0.05 * mu * torch.randn((k, SVC_RING), generator=gen, device=device)
    state = gibbs.init_state(gen, mu_guess=1.25, shape=(k,))
    config = sched.SchedulerConfig(n_iters=SWEEPS, grid_size=SVC_G)
    every = torch.arange(k, device=device)
    paths = {
        "gibbs_batch": lambda g, idx: gibbs.gibbs_batch(
            state, t, f, generator=g, n_iters=SWEEPS, grid_size=SVC_G, active_idx=idx),
        "advance_fleet": lambda g, idx: sched.advance_fleet(state, t, f, config, g, active_idx=idx),
    }
    for name, run in paths.items():
        seeded = lambda: torch.Generator(device=device).manual_seed(11)
        assert_bitwise(f"{name} active at arange(K)", run(seeded(), every), run(seeded(), None))
        say(f"[service] (a) {name} K={k} G={SVC_G} N={SVC_RING}, {SWEEPS} sweeps: active path at "
            f"arange(K) bitwise the dense path")

    grid, t, f, mask, mu, lam, alpha, beta, aa, ab, ba, bb = fleet_case(
        SVC_K, SVC_G, SVC_RING, seed=9, device=device)
    kw = dict(symmetric_grid=True)
    args = (grid, t, f, mu, lam, alpha, beta, BetaParams(aa, ab), BetaParams(ba, bb), mask)
    dense = ops.posterior_grid_fleet(*args, **kw)
    assert_bitwise("K1 slab at arange(K)", ops.posterior_grid_fleet(
        *args, active_idx=torch.arange(SVC_K, device=device), **kw), dense)
    idx = torch.randperm(SVC_K, generator=gen, device=device)[:SVC_M]
    prev = torch.full_like(dense, 7.0)
    part = ops.posterior_grid_fleet(*args, active_idx=idx, out_prev=prev, **kw)
    outside = torch.ones(SVC_K, dtype=torch.bool, device=device).index_fill(0, idx, False)
    assert_bitwise("K1 slab rows", part.index_select(0, idx), dense.index_select(0, idx))
    if not bool((part[outside] == 7.0).all()):
        raise AssertionError("K1 slab launch wrote rows outside active_idx")
    say(f"[service] (b) K1 slab K={SVC_K} G={SVC_G} N={SVC_RING}: arange(K) bitwise the dense "
        f"launch; M={SVC_M} random rows bitwise the dense rows, the other {SVC_K - SVC_M} "
        f"untouched")


def check_select_active(device):
    """(c): select_active on the device against a stable descending sort on
    the host, with ties, dead slots, fewer live slots than M, and the
    saturated ages of start-up."""
    import numpy as np
    import torch
    from repro_torch.core import compress

    gen = torch.Generator(device=device).manual_seed(4)
    u = lambda: torch.rand((SVC_K,), generator=gen, device=device)
    age = torch.randint(0, 4, (SVC_K,), generator=gen, device=device, dtype=torch.int32)
    nu = torch.where(u() < 0.5, 1.0, 200.0)
    cases = {
        "ties, 10 % dead": dict(age=age, nu=nu, live=(u() > 0.1).float()),
        f"ties, {SVC_M // 2} live": dict(age=age, live=(torch.arange(SVC_K, device=device)
                                                        % (2 * SVC_K // SVC_M) == 0).float()),
        "start-up (all ages saturated)": dict(age=torch.full((SVC_K,), 1_000_000, device=device,
                                                             dtype=torch.int32)),
    }
    for name, kw in cases.items():
        idx, pri = compress.select_active(SVC_M, **kw)
        want = np.argsort(-pri.cpu().numpy(), kind="stable")[:SVC_M]
        if not np.array_equal(idx.cpu().numpy(), want):
            raise AssertionError(f"select_active ({name}) differs from a stable sort")
        say(f"[service] (c) select_active K={SVC_K} M={SVC_M} {name}: the indices of a stable "
            f"descending sort on the host")


def check_round_robin(device, k=8192, m=512):
    """(d): every worker has had a full refresh within ceil(K/M) data ticks."""
    import torch
    from repro_torch import serve
    from repro_torch.device import no_sync

    loop = serve.ServiceLoop(k, config=service_config(k, active=m, async_propose=False,
                                                      opt_steps=10, num_points=64),
                             seed=2, device=device)
    fracs, times = service_truth(k, device, seed=5)
    seen = torch.zeros(k, dtype=torch.bool, device=device)
    ticks = -(-k // m)
    for _ in range(ticks):
        for _ in range(SVC_RING):
            loop.push(fracs, times())
        loop.tick()
        seen |= loop.state.refresh_age == 0
    if not bool(seen.all()):
        raise AssertionError(f"{int((~seen).sum())} workers not refreshed in {ticks} ticks")
    say(f"[service] (d) K={k} M={m}: every worker refreshed within {ticks} data ticks "
        f"(sync propose published version {loop.version})")

    # The branches (e) leaves out, under sync-debug "error" too: hierarchical
    # pooling (surprise in the selection, the hyperprior refit and shrink
    # every 2 drains) and the calibrated gate.
    config = service_config(k, active=m, opt_steps=10, num_points=64)
    config = dataclasses.replace(
        config, sched=dataclasses.replace(config.sched, hierarchical=True, hyper_refit_every=2),
        drift_threshold=None, max_staleness=3)
    loop = serve.ServiceLoop(k, config=config, seed=3, device=device)
    for _ in range(6):
        for _ in range(SVC_RING):
            loop.push(fracs, times())
        loop.tick(no_sync(device))
    loop.poll()
    if not (float(loop.state.hyper.n_workers) == k and int(loop.state.gate.count) >= 1
            and loop.version >= 1 and abs(float(loop.fractions().sum()) - 1.0) < 1e-4):
        raise AssertionError(f"hierarchical service: {loop.counters()}, gate count "
                             f"{int(loop.state.gate.count)}, version {loop.version}")
    say(f"[service] (d) K={k} M={m} hierarchical, calibrated gate, async: 6 ticks with no sync "
        f"before the flag read, {loop.counters()['proposes']} proposes, gate count "
        f"{int(loop.state.gate.count)}")


def drive_service(device, active):
    """(e): one ServiceLoop at K = 100 000, async propose, every advance
    under sync-debug "error"; returns its measurements."""
    import numpy as np
    import torch
    from repro_torch import kernels, serve, sched
    from repro_torch.device import no_sync

    torch.cuda.synchronize()
    m = dict(tick_ms=[], dispatch_ms=[], publish_ms=[], memory=[], advance_peak=0, tick_peak=0,
             before=torch.cuda.memory_allocated())
    config = service_config(SVC_K, active=active)
    loop = serve.ServiceLoop(SVC_K, config=config, seed=1, device=device)
    fracs, times = service_truth(SVC_K, device, seed=4)

    @contextlib.contextmanager
    def advance():  # the tick's work before its flag read, with no sync; its peak memory
        with no_sync(device):
            yield
        m["advance_peak"] = max(m["advance_peak"], torch.cuda.max_memory_allocated())

    for _ in range(1 + SVC_TICKS):
        for _ in range(SVC_RING):
            loop.push(fracs, times())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernels.launch_counts()["posterior_grid_fleet"]
        t0 = time.perf_counter()
        info = loop.tick(advance())
        m["tick_ms"].append((time.perf_counter() - t0) * 1e3)
        launched = kernels.launch_counts()["posterior_grid_fleet"] - before
        if not info.proposed or info.drained != SVC_RING or launched != SWEEPS:
            raise AssertionError(f"tick: proposed {info.proposed}, drained {info.drained}, "
                                 f"K1 launched {launched} times, not {SWEEPS}")
        while not loop.poll():
            time.sleep(1e-4)
        published = time.perf_counter()
        m["tick_peak"] = max(m["tick_peak"], torch.cuda.max_memory_allocated())
        start, end = loop.last_dispatch
        if start < t0:
            raise AssertionError("the tick dispatched no solve")
        m["dispatch_ms"].append((end - start) * 1e3)
        m["publish_ms"].append((published - start) * 1e3)
        fr = loop.fractions()
        if not (np.isfinite(fr).all() and abs(float(fr.sum()) - 1.0) < 1e-4):
            raise AssertionError(f"published split not finite or sums to {float(fr.sum())}")
        torch.cuda.synchronize()
        torch.empty((), device=device)  # frees the blocks that waited on the side stream
        m["memory"].append(torch.cuda.memory_allocated())
    c = loop.counters()
    if c["dropped"] or c["drains"] != 1 + SVC_TICKS or loop.version != 1 + SVC_TICKS:
        raise AssertionError(f"counters {c}, version {loop.version}")
    # Two more solves on the same beliefs, each under its own profiler: CUDA
    # events around it, and the sum of its kernels' device time, whose
    # difference is the time the card waits for the host's launches.
    m["solve_ms"], m["solve_kernel_ms"] = [], []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            start.record()
            serve.solve_published(sched.unit_params(loop.state.sched), config)
            end.record()
            end.synchronize()
        m["solve_ms"].append(start.elapsed_time(end))
        m["solve_kernel_ms"].append(sum(e.device_time_total for e in prof.key_averages()) / 1e3)
    if max(m["memory"][1:]) > m["memory"][0]:
        raise AssertionError(f"device memory grew across ticks: {m['memory']}")
    m["loop"] = loop  # phase 13 checkpoints the dense loop's state
    return m


def check_capacity(device, live_k=4096):
    """(f): a capacity state of 2 x ``live_k`` slots runs admit n -> observe ->
    propose -> retire n -> propose (n = live_k / 8, 512 at 4096) with no sync;
    dead slots get exactly 0 of the proposal and of the quantized
    microbatches."""
    import torch
    from repro_torch import sched
    from repro_torch.device import no_sync

    cap, n = 2 * live_k, live_k // 8
    config = sched.SchedulerConfig(min_fraction=1.0 / (8 * cap))
    state = sched.init(config, live_k, seed=5, device=device, capacity=cap)
    gen = torch.Generator(device=device).manual_seed(6)
    f = 0.05 + 0.9 * torch.rand((cap, SVC_RING), generator=gen, device=device)
    telem = sched.Telemetry(fracs=f, times=f**0.9 * torch.linspace(5.0, 40.0, cap, device=device)[:, None])
    dead = torch.zeros(cap, dtype=torch.bool, device=device)
    dead[torch.randperm(live_k + n, generator=gen, device=device)[:n]] = True
    with no_sync(device):
        state = sched.admit_workers(state, n, config)
        state, _ = sched.observe(state, telem, config)
        admitted_fr, _ = sched.propose(state, config)
        admitted_live = state.live
        state = sched.retire_workers(state, dead)
        fr, stats = sched.propose(state, config)
    live = state.live.cpu().numpy() > 0
    admitted = admitted_live.cpu().numpy() > 0
    total = 8 * int(live.sum())
    counts = sched.quantize_fractions(fr.cpu().numpy(), total, sched.unit_params(state),
                                      objective=config.objective, live=live)
    fr, admitted_fr = fr.cpu().numpy(), admitted_fr.cpu().numpy()
    if not (admitted.sum() == live_k + n and live.sum() == live_k
            and (admitted_fr[~admitted] == 0).all() and (fr[~live] == 0).all()
            and (fr[live] > 0).all() and abs(fr.sum() - 1) < 1e-4
            and (counts[~live] == 0).all() and (counts[live] >= 1).all() and counts.sum() == total):
        raise AssertionError("capacity slots: a dead slot got work, or a live one none")
    say(f"[service] (f) capacity {cap}: admit {n} -> observe -> propose -> retire {n} -> "
        f"propose with no sync; {int((~live).sum())} dead slots get exactly 0 of the proposal and of "
        f"{total} quantized microbatches")
    # Fault 3f: with every slot live, one batch of N = 16 counts N a worker,
    # as the exact-size state does: nu0 = discount x 1 + N / 2.
    f = 0.05 + 0.9 * torch.rand((live_k, 16), generator=gen, device=device)
    telem = sched.Telemetry(fracs=f, times=f**0.9 * torch.linspace(5.0, 40.0, live_k, device=device)[:, None])
    nu = {tag: sched.observe(sched.init(config, live_k, seed=7, device=device, capacity=c), telem,
                             config)[0].gibbs.ng.nu0 for tag, c in (("capacity", live_k), ("exact", None))}
    if not torch.allclose(nu["capacity"], nu["exact"], rtol=1e-6, atol=0.0):
        raise AssertionError(f"fault 3f: a capacity state's nu0 {nu['capacity'][:4].tolist()} is "
                             f"not the exact-size state's {nu['exact'][:4].tolist()}")
    span = lambda x: f"{float(x.min()):.4f}-{float(x.max()):.4f}"
    say(f"[service] (f) every one of {live_k} slots live, one batch of N = 16: nu0 of the capacity "
        f"state {span(nu['capacity'])}, of the exact-size state {span(nu['exact'])} (discount "
        f"{config.discount:g} x 1 + N / 2 = {config.discount + 8:g})")


def phase_service(device="cuda"):
    """Slice 5's main path: the always-on estimator service at fleet scale."""
    from repro_torch import kernels
    from repro_torch.core import compress

    check_active_parity(device, k=K_FLEET)
    check_select_active(device)
    check_round_robin(device)

    kernels.reset_launch_counts()
    runs = {mode: drive_service(device, active) for mode, active in (("dense", None),
                                                                      ("active", SVC_M))}
    launches = kernels.launch_counts()
    report = compress.compression_report(SVC_K, SVC_G, SVC_M)
    for mode, m in runs.items():
        timed = m["tick_ms"][1:]
        advance = [t - d for t, d in zip(m["tick_ms"][1:], m["dispatch_ms"][1:])]
        say(f"[service] (e) {mode} K={SVC_K} G={SVC_G} M={SVC_M if mode == 'active' else SVC_K}: "
            f"tick p50 {statistics.median(timed):.1f} ms, max {max(timed):.1f} ms over "
            f"{len(timed)} data ticks (first {m['tick_ms'][0]:.1f} ms), of which the async "
            f"dispatch takes {statistics.median(m['dispatch_ms'][1:]):.1f} ms of host time (p50) "
            f"and the rest, drain to the flag read, p50 {statistics.median(advance):.1f} ms, max "
            f"{max(advance):.1f} ms; dispatch to publish "
            f"{statistics.median(m['publish_ms'][1:]):.1f} ms (p50)")
        mib = lambda x: (x - m["before"]) / 2**20
        solves = ", ".join(
            f"{total:.1f} ms between CUDA events, of which its kernels run {kern:.1f} ms (the card "
            f"idles {100 * (1 - kern / total):.1f} %)"
            for total, kern in zip(m["solve_ms"], m["solve_kernel_ms"]))
        say(f"[service] (e) {mode}: two solves, each under torch.profiler: {solves}; peak "
            f"device memory above the "
            f"{m['before'] / 2**20:.1f} MiB allocated before the loop: "
            f"{mib(m['advance_peak']):.1f} MiB up to the flag read, "
            f"{mib(m['tick_peak']):.1f} MiB with the solve; allocated after each tick "
            f"{[round(mib(x), 1) for x in m['memory']]} MiB (no growth)")
    say(f"[service] compression_report({SVC_K}, {SVC_G}, {SVC_M}): dense "
        f"{report.dense_bytes / 2**20:.1f} MiB, compressed {report.compressed_bytes / 2**20:.1f} "
        f"MiB, ratio {report.ratio:.1f}")

    check_capacity(device)
    say(f"[service] launches on the main path (e): {launches}")
    return launches, runs


# The smoke condition is asserted at the drift gate the reference's own
# --serve-smoke asserts it at, 0.12: at the default 0.05 the reference fails
# it for 15 of the service's seeds 1-24 and the port for 13, alike by
# Fisher's exact test and in their converged drifts
# (tests/test_torch_serve.py::
# test_partitioned_serving_gate_at_the_default_threshold_skips_as_the_reference).
PART_ARGV = ["--arch", "recurrentgemma-2b", "--full", "--rounds", "16", "--replicas", "4",
             "--batch", "16", "--prompt-len", "1024", "--gen-len", "16", "--drain-every", "4",
             "--drift-threshold", "0.12"]


# Phase 10b (fault 3d): partitioned serving of internvl2-1b at full width on
# its text alone, as the reference's launch.serve serves it; the drift gate at the
# default 0.05 (phase 10 asserts the smoke condition).
PART_VLM_ARGV = ["--arch", "internvl2-1b", "--full", "--rounds", "4", "--replicas", "4",
                 "--batch", "16", "--prompt-len", "512", "--gen-len", "8", "--drain-every", "2"]


def part_arg(name: str, argv) -> int:
    return int(argv[argv.index(name) + 1])


def attention_layers(cfg) -> int:
    """Layers that launch K2 once a decode step (an encoder-decoder's decoder
    layer twice: its self cache, then its cross cache)."""
    from repro_torch.models.transformer import MIXERS, layer_kinds

    attends = sum(kind not in MIXERS for kind in layer_kinds(cfg))
    return attends * (2 if cfg.family == "encdec" else 1)


def phase_partitioned(tag, argv, *, smoke=False):
    """Partitioned serving at full width: ``python -m repro_torch.launch.serve``
    with ``argv``, in this process so that its launches are counted (phase 10
    with PART_ARGV, 10b with PART_VLM_ARGV): a push every round and a drain
    every ``--drain-every`` rounds, with ``smoke`` the reference smoke's
    condition too (launch/serve.py:150-155), finite published splits
    summing to 1; K1 at each drain's sweeps, K3 once per RG-LRU layer of
    each round's prefill, K2 at every attention layer of every decode step.
    Then each kernel against its plain version at the shapes the run gave
    it.  Returns the launches and each kernel's max |err|."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import layer_kinds

    cfg = get_arch(argv[argv.index("--arch") + 1])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = launch_serve.main(argv)
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    c, rounds = result["counters"], part_arg("--rounds", argv)
    drains = rounds // part_arg("--drain-every", argv)
    if (c["pushes"], c["drains"]) != (rounds, drains):
        raise AssertionError(f"[{tag}] {c}: not {rounds} pushes and {drains} drains")
    if smoke and not (c["proposes"] >= 1 and c["drains"] > c["proposes"]):
        raise AssertionError(f"[{tag}] serve-smoke condition fails: {c}")
    want = dict(posterior_grid_fleet=result["config"].sched.n_iters * drains,
                lru_scan=layer_kinds(cfg).count("rglru") * rounds, lru_scan_bwd=0,
                decode_attention=attention_layers(cfg) * (part_arg("--gen-len", argv) - 1) * rounds)
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, not {want}")
    for fr in result["published"]:
        if not (np.isfinite(fr).all() and abs(float(fr.sum()) - 1.0) < 1e-5):
            raise AssertionError(f"a published split is not finite or sums to {fr.sum()}")
    say(f"[{tag}] {' '.join(argv)}: {seconds:.1f} s, {c}; requests of replica 0 by round "
        f"{[int(n[0]) for n in result['counts']]}; {len(result['published'])} published splits "
        f"finite and summing to 1")
    say(f"[{tag}] oracle makespan: equal split {result['oracle_equal']:.4f} s, learned split "
        f"{result['oracle_learned']:.4f} s ({np.round(result['fractions'], 4).tolist()})")
    say(f"[{tag}] launches on the main path: {launches}")
    return launches, phase_partitioned_parity(result, cfg, argv)


def phase_partitioned_parity(result, cfg, argv):
    """Each kernel against its plain version at the shapes a partitioned
    serving run (phase 10, or 10b with its ``argv``) gave it: K1 at
    (replicas, the service's grid, the ring's capacity) in both modes; for
    every batch replica 0 served, K3 at (batch, prompt, d_model) in float32,
    with decays near 1 and from a sigmoid (where the arch has RG-LRU
    layers), and K2 at (batch, heads, kv heads, head dim, cache rows) with a
    bfloat16 query and a float32 cache, at the lengths of the first and the
    last decode step and those between.  Returns each kernel's max |err|."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
    from repro_torch.kernels.lru_scan import lru_scan, lru_scan_plain
    from repro_torch.kernels.posterior_grid import posterior_grid_fleet, posterior_grid_plain

    errs = dict(posterior_grid_fleet=0.0, decode_attention=0.0, lru_scan=0.0)
    config = result["config"]
    k, g, n = part_arg("--replicas", argv), config.sched.grid_size, config.capacity
    for sym in (True, False):
        args = fleet_case(k, g, n, seed=400, device="cuda")
        want = posterior_grid_plain(*args, symmetric_grid=sym)
        err, rel = assert_logp_close(posterior_grid_fleet(*args, symmetric_grid=sym), want)
        errs["posterior_grid_fleet"] = max(errs["posterior_grid_fleet"], err)
        say(f"[part-parity] K1 {'mirrored' if sym else 'general '} K={k} G={g} N={n}: max|err| "
            f"{err:.3e}; over its row's 1 + max|logp| {rel:.3e} within rtol {RTOL:g}")
    prompt, gen = part_arg("--prompt-len", argv), part_arg("--gen-len", argv)
    rows = prompt + gen + 8  # launch/serve.py's cache; a local window's ring holds the window
    rows = min(cfg.local_window, rows) if cfg.local_window else rows
    first, last = min(prompt + 1, rows), min(prompt + gen - 1, rows)  # valid rows, decode steps
    shape = lambda b: (b, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, rows)
    batches = sorted({int(c[0]) for c in result["counts"]})
    for i, b in enumerate(batches):
        for near_one, tol in ((True, 1e-5), (False, 1e-5)) if "rglru" in cfg.pattern else ():
            a, x, h0 = scan_case(b, prompt, cfg.d_model, seed=410 + i, dtype=torch.float32,
                                 near_one=near_one)
            err = assert_close(lru_scan(a, x, h0), lru_scan_plain(a, x, h0), tol, tol)
            errs["lru_scan"] = max(errs["lru_scan"], err)
            say(f"[part-parity] K3 (B, T, R)=({b}, {prompt}, {cfg.d_model}) float32 "
                f"{'a in [0.9, 0.9999)' if near_one else 'a = sigmoid(N(0, 1))'}: max|err| "
                f"{err:.3e} within {tol:g}")
        lengths = [first, last] + [first + j % (last - first + 1) for j in range(b - 2)]
        args = decode_case(*shape(b), seed=420 + i, q_dtype=torch.bfloat16,
                           kv_dtype=torch.float32, length=lengths[:b])
        err = assert_close(decode_attention(*args), decode_attention_plain(*args), 1e-3, 1e-3)
        errs["decode_attention"] = max(errs["decode_attention"], err)
        say(f"[part-parity] K2 (B, H, KVH, D, S)={shape(b)} q bfloat16 cache float32 lengths "
            f"{args[3].tolist()}: max|err| {err:.3e} within 1e-03")
    torch.cuda.synchronize()
    return errs


def serve_cli(tag, argv, batch, gen, *, warm_up=True):
    """Serve through ``python -m repro_torch.launch.serve``'s entry point in
    this process (after a 2-token run at the same shapes with ``warm_up``),
    the launch counts set to 0 just before the timed run and read just
    after; one more decode step on its cache.  Checks the tokens' shape and
    range and finite logits; returns (launches, the run's result, peak
    device memory in bytes)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx

    if warm_up:
        launch_serve.main(argv + ["--gen-len", "2"])  # set-up at the same shapes
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = launch_serve.main(argv)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cfg, tokens = out["cfg"], out["tokens"]
    logits, _ = model_zoo.decode_step(cfg, out["params"], tokens[:, -1:], out["cache"],
                                      ctx=ApplyCtx(mode="decode"))
    if logits.shape != (batch, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[{tag}] logits {tuple(logits.shape)} not finite or misshapen")
    if tokens.shape != (batch, gen) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"[{tag}] generated tokens {tuple(tokens.shape)} out of shape or range")
    # every attention layer in every decode step; the encoder never
    want = attention_layers(cfg) * (gen - 1)
    if launches.get("decode_attention") != want:
        raise AssertionError(f"[{tag}] K2 launched {launches} times, not {want}")
    k2 = (f"K2 at (G, D) = ({cfg.num_heads // cfg.num_kv_heads}, {cfg.resolved_head_dim})"
          if want else "no attention layer")
    say(f"[{tag}] {' '.join(argv)}: {cfg.num_layers} layers, {k2}; prefill "
        f"{out['prefill_ms']:.1f} ms, decode {out['decode_ms']:.2f} ms/token, peak device memory "
        f"{peak / 2**30:.2f} GiB, logits finite")
    say(f"[{tag}] launches on the main path: {launches}")
    return launches, out, peak


def phase_serve_smollm():
    """Phase 7b: smollm-135m at full width through the serving CLI's entry
    point; K2 at (G, D) = (3, 64) once per layer of every decode step."""
    launches, _, _ = serve_cli("smollm", SMOLLM_ARGV, SMOLLM_BATCH, SMOLLM_GEN)
    return launches


def phase_serve_granite():
    """Phase 7c: granite-moe-3b-a800m at full width through the serving
    CLI's entry point, at the config's capacity factor (1.25: a decode
    step's 4 tokens get one row of each of 40 experts, and most of their 8
    slots are dropped, as in the reference); K2 at (3, 64) 32 times a
    decode step.  Returns the launches and cycle 0's MoE parameters, in
    float32 on the host."""
    from repro_torch.models import model_zoo

    launches, out, _ = serve_cli("granite", GRANITE_ARGV, GRANITE_BATCH, GRANITE_GEN)
    cfg = out["cfg"]
    say(f"[granite] {cfg.name}: {model_zoo.param_count(cfg) / 1e9:.3f} B parameters in "
        f"{cfg.dtype} ({model_zoo.param_count(cfg, active_only=True) / 1e9:.3f} B active a "
        f"token), {cfg.num_experts} experts top-{cfg.experts_per_token}, capacity factor "
        f"{cfg.capacity_factor}")
    ffn = {name: t[0].float().cpu() for name, t in out["params"]["cycles"][0]["ffn"].items()}
    return launches, ffn


def check_moe_layer_parity(ffn):
    """granite's cycle-0 MoE layer at full width, its weights in float32, on
    MOE_TOKENS tokens at the config's capacity factor, on the card against
    the same layer on the CPU: expert ids, positions and the keep mask
    bitwise, the output within rtol 1e-4, atol 1e-4.

    The tokens (integers in [-3, 3], plus one shared integer vector that
    favours some experts, so that those overflow and drop) and the router
    (rounded to multiples of 2^-12) lie on a lattice where every partial sum
    of the router's product is exact in float32: both devices see the same
    logits, so the check holds the card's top-k order and scatter, not its
    matmul rounding.  Equal logits tie on both and go to the lower expert."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    cfg = get_arch(GRANITE_ARCH)
    rng = np.random.default_rng(11)
    shared = rng.integers(-2, 3, (1, cfg.d_model))
    x = torch.as_tensor(np.clip(rng.integers(-3, 4, (MOE_TOKENS, cfg.d_model)) + shared, -3, 3),
                        dtype=torch.float32)
    params = dict(ffn, router=torch.round(ffn["router"] * 2**12) / 2**12)
    cap = moe._capacity(MOE_TOKENS, cfg)
    results = {}
    for device in ("cuda", "cpu"):
        p = {name: t.to(device) for name, t in params.items()}
        xd = x.to(device)
        _, gates, experts = moe._route(cfg, p["router"], xd)
        _, e_ids, pos, keep = moe._dispatch_local(xd, gates, experts, cfg.num_experts, cap)
        y, _ = moe.moe_ffn(cfg, p, xd[None])
        results[device] = [t.cpu() for t in (e_ids, pos, keep, y[0])]
    card, host = results["cuda"], results["cpu"]
    for name, got, want in zip(("expert ids", "positions", "keep mask"), card[:3], host[:3]):
        if not torch.equal(got, want):
            raise AssertionError(f"[moe-layer] {name} differ between the card and the CPU in "
                                 f"{int((got != want).sum())} places")
    err = assert_close(card[3], host[3], rtol=1e-4, atol=1e-4)
    keep = host[2]
    say(f"[moe-layer] {cfg.name} cycle-0 MoE layer, float32, {MOE_TOKENS} tokens, capacity "
        f"{cap} a expert (factor {cfg.capacity_factor}): {int((~keep).sum())} of {keep.numel()} "
        f"(token, slot) pairs dropped; expert ids, positions and keep mask bitwise equal on the "
        f"card and the CPU; output max|err| {err:.3e} within rtol 1e-4, atol 1e-4 (max|y| "
        f"{float(host[3].abs().max()):.3f})")
    if not bool((~keep).any()):
        raise AssertionError("[moe-layer] no token was dropped: the check would not see drops")
    return err


def phase_teacher_forcing_granite():
    """granite-moe-3b-a800m at full width in float32, the capacity factor at
    E / k (dropless in every mode: capacity is then the call's token count),
    prefill then teacher-forced decode steps against the full forward.  At
    the config's 1.25 a decode step drops tokens that the full forward
    keeps, by design (GShard), so the two would differ."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import model_zoo

    base = get_arch(GRANITE_ARCH)
    cfg = dataclasses.replace(base, dtype="float32",
                              capacity_factor=base.num_experts / base.experts_per_token)
    params = model_zoo.init_model_params(cfg, seed=0)
    worst = teacher_forcing(cfg, params, GRANITE_TF_BATCH, GRANITE_TF_PREFILL, TF_STEPS,
                            "moe-teacher")
    say(f"[moe-teacher] {cfg.name} float32, capacity factor E/k = {cfg.capacity_factor:g} "
        f"(dropless; the config's {base.capacity_factor} drops decode tokens by design), batch "
        f"{GRANITE_TF_BATCH}, prefill {GRANITE_TF_PREFILL}, {TF_STEPS} decode steps: within rtol "
        f"{TF_TOL['rtol']} atol {TF_TOL['atol']}, worst {worst:.3e}")
    return worst


def serve_at_depth(tag, argv, batch, gen, layers):
    """Serve ``argv``'s arch at full width with its depth cut to ``layers``
    through the serving CLI's entry point (the cut goes through the
    registry's config, for this call only): one run, no warm-up (one run of
    tens of GB of weights is enough).  Returns (launches, the cut config,
    peak device memory in bytes, seconds with initialisation)."""
    import torch
    from repro_torch import configs

    arch = argv[argv.index("--arch") + 1]
    full = configs.ARCHS[arch]
    cut = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    configs.ARCHS[arch] = cut
    try:
        t0 = time.perf_counter()
        launches, out, peak = serve_cli(tag, argv, batch, gen, warm_up=False)
        seconds = time.perf_counter() - t0
    finally:
        configs.ARCHS[arch] = full
    del out
    torch.cuda.empty_cache()
    return launches, cut, peak, seconds


def phase_serve_arctic():
    """Phase 7d: arctic-480b at full width (d_model 7168, 128 experts top-2
    and the dense residual FFN) with its depth cut to ARCTIC_LAYERS of 35,
    through the serving CLI's entry point: one prefill and ARCTIC_GEN - 1
    decode steps; K2 at (7, 128)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model_zoo

    launches, cut, peak, seconds = serve_at_depth("arctic", ARCTIC_ARGV, ARCTIC_BATCH,
                                                  ARCTIC_GEN, ARCTIC_LAYERS)
    full, n = get_arch(ARCTIC_ARCH), model_zoo.param_count(cut)
    say(f"[arctic] {cut.name} at full width, {ARCTIC_LAYERS} of {full.num_layers} layers: "
        f"{n / 1e9:.3f} B parameters in {cut.dtype} ({n * 2 / 1e9:.1f} GB; the whole model "
        f"{model_zoo.param_count(full) / 1e9:.1f} B), peak device memory {peak / 2**30:.2f} GiB, "
        f"{seconds:.1f} s with initialisation")
    return launches


def phase_serve_whisper():
    """Phase 7e: whisper-medium at full width through the serving CLI's
    entry point (zero frames, as the reference's latency demo); K2 at (1, 64)
    twice a decoder layer and decode step, over the self cache and over
    the 1500-row cross cache.  Then the encoder alone on the same frames,
    the median of 3 calls: the part of the prefill that is the encoder's."""
    import torch
    from repro_torch.models import encdec
    from repro_torch.models.layers import ApplyCtx

    arch, batch, _, gen = WHISPER
    launches, out, peak = serve_cli("whisper", WHISPER_ARGV, batch, gen)
    cfg, params = out["cfg"], out["params"]
    frames = torch.zeros((batch, cfg.encoder_seq, cfg.d_model), device=params["embed"].device)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encdec.encode(cfg, params["encoder"], frames, ctx=ApplyCtx(mode="prefill"))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    say(f"[whisper] {arch}: {cfg.encoder_layers} encoder layers over {cfg.encoder_seq} frames "
        f"take {statistics.median(times):.1f} ms (median of 3) of the prefill's "
        f"{out['prefill_ms']:.1f} ms; the decoder's {cfg.num_layers} layers launch K2 twice a "
        f"decode step")
    return launches


def phase_serve_family(tag, case, argv):
    """Phases 7f and 7g: one arch at full width through the serving CLI's
    entry point, as phase 7b."""
    launches, out, _ = serve_cli(tag, argv, case[1], case[3])
    cfg = out["cfg"]
    say(f"[{tag}] {cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters in {cfg.dtype}, "
        f"{cfg.vision_patches} vision patches before each prompt, biases {cfg.use_bias}, rope "
        f"theta {cfg.rope_theta:g}")
    return launches


def phase_serve_command_r():
    """Phase 7h: command-r-35b at full width and full depth (vocabulary
    256 000, rope theta 8e6), one prefill and 3 decode steps, no warm-up (one
    run of 60 GB of weights is enough); K2 at (8, 128)."""
    import torch

    arch, batch, _, gen = COMMAND_R
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, out, peak = serve_cli("command-r", COMMAND_R_ARGV, batch, gen, warm_up=False)
    seconds = time.perf_counter() - t0
    cfg = out["cfg"]
    n = cfg.param_count()
    del out
    torch.cuda.empty_cache()
    say(f"[command-r] {cfg.name} at full width, all {cfg.num_layers} layers: "
        f"{n / 1e9:.3f} B parameters in {cfg.dtype} ({n * 2 / 1e9:.1f} GB, "
        f"{n * 2 / 2**30:.1f} GiB), peak device memory {peak / 2**30:.2f} GiB, {seconds:.1f} s "
        f"with initialisation")
    return launches


def time_block_prefill(cfg, params, kind, batch, prompt):
    """One ``kind`` block's prefill (``transformer.block_apply``) at (batch,
    prompt, d_model) on a random input in the parameters' dtype, its cycle-0
    parameters, from a fresh cache: the median of BLOCK_RUNS CUDA-event
    timings after a warm-up, in ms."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.layers import ApplyCtx
    from repro_torch.models.params import tree_map

    device = params["embed"].device
    p = tree_map(lambda t: t[0], params["cycles"][cfg.pattern.index(kind)])
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn((batch, prompt, cfg.d_model), generator=gen, device=device).to(
        params["embed"].dtype)
    positions = torch.arange(prompt, device=device)
    times = []
    for i in range(BLOCK_RUNS + 1):  # the first is the warm-up
        cache = transformer.init_block_cache(cfg, kind, batch, prompt, torch.float32, device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        transformer.block_apply(cfg, kind, p, x, ctx=ApplyCtx(mode="prefill"),
                                positions=positions, length=None, cache=cache)
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_serve_xlstm():
    """Phase 7i: xlstm-1.3b at full width and depth through the serving
    CLI's entry point, as phase 7f; no kernel launches on this path.  Then
    one sLSTM block's prefill and one mLSTM block's at the same shape,
    timed apart: what the sLSTM's loop over time costs of the prefill."""
    _, batch, prompt, gen = XLSTM
    launches, out, _ = serve_cli("xlstm", XLSTM_ARGV, batch, gen)
    if any(launches.values()):
        raise AssertionError(f"[xlstm] the attention-free path launched {launches}")
    from repro_torch.models.transformer import layer_kinds

    cfg, params = out["cfg"], out["params"]
    kinds = layer_kinds(cfg)
    ms = {kind: time_block_prefill(cfg, params, kind, batch, prompt) for kind in ("slstm", "mlstm")}
    share = {kind: ms[kind] * kinds.count(kind) for kind in ms}
    say(f"[xlstm] {cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters in {cfg.dtype}, "
        f"{kinds.count('mlstm')} mLSTM and {kinds.count('slstm')} sLSTM layers, no K1, K2 or K3 "
        f"launch: {launches}")
    say(f"[xlstm] one block's prefill at (B, T, D) = ({batch}, {prompt}, {cfg.d_model}), CUDA "
        f"events, median of {BLOCK_RUNS}: sLSTM {ms['slstm']:.2f} ms (x {kinds.count('slstm')} "
        f"= {share['slstm']:.1f} ms, {100 * share['slstm'] / out['prefill_ms']:.1f} % of the "
        f"prefill's {out['prefill_ms']:.1f} ms), mLSTM {ms['mlstm']:.2f} ms (x "
        f"{kinds.count('mlstm')} = {share['mlstm']:.1f} ms)")
    return launches


BIAS_KEYS = ("bq", "bk", "bv", "bi", "bo")


def draw_biases(tree, gen, std=0.1):
    """Redraw every bias leaf of a parameter tree from N(0, std^2) in place:
    they start at zero, where a check could not see them."""
    if isinstance(tree, list):
        for x in tree:
            draw_biases(x, gen, std)
        return
    for name, x in tree.items():
        if name in BIAS_KEYS:
            x.normal_(0.0, std, generator=gen)
        elif isinstance(x, (dict, list)):
            draw_biases(x, gen, std)


def phase_teacher_forcing_families():
    """Phase 8b: float32 teacher forcing at full width for the encoder-decoder
    (random frames) and the vision family (random patches; biases drawn),
    as phase 8.  Returns the worst |err|."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import model_zoo
    from repro_torch.models.params import tree_map

    worst = 0.0
    for arch, batch, prefill in TF_FAMILIES:
        cfg = get_arch(arch)
        params = tree_map(lambda t: t.float(), model_zoo.init_model_params(cfg, seed=0))
        draw_biases(params, torch.Generator(device=params["embed"].device).manual_seed(5))
        err = teacher_forcing(cfg, params, batch, prefill, TF_STEPS, "family-teacher")
        worst = max(worst, err)
        say(f"[family-teacher] {cfg.name} float32 ({cfg.vision_patches} patches, "
            f"{cfg.encoder_seq if cfg.family == 'encdec' else 0} frames, biases "
            f"{'drawn' if cfg.use_bias else 'none'}), batch {batch}, prefill {prefill}, "
            f"{TF_STEPS} decode steps: within rtol {TF_TOL['rtol']} atol {TF_TOL['atol']}, "
            f"worst {err:.3e}")
        del params
        torch.cuda.empty_cache()
    return worst


def hold_at_init(cfg, cache, kind, batch):
    """Set every ``kind`` layer's state in a model cache back to its initial
    values, as a block that never writes its cache would leave it."""
    import torch
    from repro_torch.models import transformer

    init = transformer.init_block_cache(cfg, kind, batch, 1, torch.float32,
                                        cache["length"].device)
    for k, layer in [*zip(cfg.pattern, cache["cycles"]), *zip(cfg.pattern, cache["rest"])]:
        if k == kind:
            for key, t in layer.items():
                t.copy_(init[key])  # a stacked cache's layer axis broadcasts


def state_errors(cfg, cache, ref):
    """For each recurrent kind and state tensor, max |cache - ref| over the
    layers of that kind, relative to max |ref|."""
    out = {}
    for k, got, want in [*zip(cfg.pattern, cache["cycles"], ref["cycles"]),
                         *zip(cfg.pattern, cache["rest"], ref["rest"])]:
        for key in want:
            rel = float((got[key] - want[key]).abs().max() / want[key].abs().max())
            out[f"{k}.{key}"] = max(out.get(f"{k}.{key}", 0.0), rel)
    return out


def phase_teacher_forcing_xlstm():
    """Phase 8c: xlstm-1.3b at full width in float32, as phase 8: one
    sequence, a prefill of XLSTM_TF_PREFILL tokens (two query chunks of
    the mLSTM's parallel form, where the full forward's 4099 take one) and
    TF_STEPS teacher-forced decode steps from the cache both block kinds
    wrote, within TF_TOL.  The prefill's own logits need no cache, so their
    error is what float32 rounding alone gives at this size.  Then the
    states the decode steps leave against those a prefill of all 4099
    tokens leaves, within XLSTM_STATE_TOL of each tensor's largest value;
    and two negative controls from the same prefill, each decode run with
    every mLSTM (then sLSTM) layer's state held at its initial values, as a
    block that never wrote its cache would leave it: TF_TOL and the state
    check must fail both.  Returns the worst |err| of the logits."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx
    from repro_torch.models.params import tree_map

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(XLSTM[0]), dtype="float32")
    params = model_zoo.init_model_params(cfg, seed=0)
    b, t, total = XLSTM_TF_BATCH, XLSTM_TF_PREFILL, XLSTM_TF_PREFILL + TF_STEPS
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (b, total)),
                           dtype=torch.int32, device=params["embed"].device)
    full, _ = model_zoo.forward_train(cfg, params, {"tokens": toks}, ctx=ApplyCtx(mode="train"))
    want = full[:, t - 1:].clone()  # (B, 1 + steps, V)
    del full

    def prefill(n):
        cache = model_zoo.init_cache(cfg, b, total + 8, torch.float32)
        return model_zoo.prefill(cfg, params, {"tokens": toks[:, :n]}, cache,
                                 ctx=ApplyCtx(mode="prefill"))

    def decode(cache, hold=None):
        outs = []
        for j in range(t, total):
            if hold:
                hold_at_init(cfg, cache, hold, b)
            got, cache = model_zoo.decode_step(cfg, params, toks[:, j:j + 1], cache,
                                               ctx=ApplyCtx(mode="decode"))
            outs.append(got)
        return outs, cache

    got, prefilled = prefill(t)
    outs, cache = decode(tree_map(torch.clone, prefilled))
    worst = check_logits([got] + outs, want, t - 1, "xlstm-teacher")
    _, ref = prefill(total)
    errs, used = {"decode": state_errors(cfg, cache, ref)}, {}
    for kind in ("mlstm", "slstm"):
        c_outs, c_cache = decode(tree_map(torch.clone, prefilled), hold=kind)
        errs[f"{kind} held"] = state_errors(cfg, c_cache, ref)
        c_err = max(float((g - want[:, i + 1]).abs().max()) for i, g in enumerate(c_outs))
        used[kind] = max(tf_used(g, want[:, i + 1]) for i, g in enumerate(c_outs))
        say(f"[xlstm-teacher] control, every {kind} state held at its initial values: logits "
            f"max|err| {c_err:.3e}, at most {100 * used[kind]:.1f} % of TF_TOL")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for what, e in errs.items():
        say(f"[xlstm-teacher] states after {TF_STEPS} steps ({what}) against a prefill of all "
            f"{total} tokens, max|err| / max|ref|: "
            + ", ".join(f"{key} {v:.3e}" for key, v in sorted(e.items())))
    say(f"[xlstm-teacher] {cfg.name} float32, batch {b}, prefill {t}, {TF_STEPS} decode steps: "
        f"logits within rtol {TF_TOL['rtol']} atol {TF_TOL['atol']}, worst {worst:.3e}; "
        f"{seconds:.1f} s with initialisation")
    if max(errs["decode"].values()) > XLSTM_STATE_TOL:
        raise AssertionError(f"[xlstm-teacher] decode's states off by {errs['decode']}")
    for kind in ("mlstm", "slstm"):
        held = {key: v for key, v in errs[f"{kind} held"].items() if key.startswith(kind)}
        if max(held.values()) <= XLSTM_STATE_TOL or used[kind] <= 1.0:
            raise AssertionError(f"[xlstm-teacher] a {kind} state held at its initial values "
                                 f"passes TF_TOL ({used[kind]:.3f} of it) or the state check "
                                 f"({held})")
    del params, prefilled, cache, ref
    torch.cuda.empty_cache()
    return worst


# Phase 11: the workflow DAG (slice 6).  S = 8 stages, K = 512 workers each
# (stage 7 256 wide), N = 256 observations per worker per batch.
DAG_K, DAG_N, DAG_MC = 512, 256, 200_000
DAG_EDGES = ((0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 4), (4, 5), (4, 6), (5, 7), (6, 7))
DAG_SCALE = (0.4, 1.6, 1.0, 0.5, 0.4, 0.8, 1.2, 0.6)
DAG_TOL = dict(mean=1.5e-2, var=8e-2)  # the reference's in-tree tolerances, printed beside


def dag_topology(k):
    """(deterministic, stochastic) topologies of phase 11 at width ``k``."""
    from repro_torch import sched

    det = sched.WorkflowDAG.from_edges(8, DAG_EDGES, num_workers=k).with_stage_workers(
        (k,) * 7 + (k // 2,))
    sto = det.with_stochastic(
        exec_probs=(1.0, 1.0, 0.3, 1.0, 1.0, 1.0, 0.5, 1.0),
        rework_probs=(0.0, 0.0, 0.0, 0.4, 0.0, 0.2, 0.0, 0.0),
        max_retries=(1, 1, 1, 4, 1, 3, 1, 1),
    )
    return det, sto


def dag_truth(k, device, seed=2016):
    """Per stage, workers k < K/2 fast and noisy (mu 5, sigma 6), the rest
    slow and precise (mu 9, sigma 0.3), as benchmarks/bench_dag.py's
    diamond; each mu jittered by e^U[-0.2, 0.2], stages scaled by
    DAG_SCALE; alpha 0.9, beta 0.55.  From a numpy seed."""
    import numpy as np
    import torch
    from repro_torch.core.frontier import UnitParams

    rng = np.random.default_rng(seed)
    fast = np.arange(k) < k // 2
    scale = np.asarray(DAG_SCALE)[:, None]
    mu = scale * np.where(fast, 5.0, 9.0)[None, :] * np.exp(rng.uniform(-0.2, 0.2, (8, k)))
    sigma = scale * np.where(fast, 6.0, 0.3)[None, :] * np.ones((8, 1))
    leaves = (mu, sigma, np.full((8, k), 0.9), np.full((8, k), 0.55))
    return UnitParams(*(torch.as_tensor(x, dtype=torch.float32, device=device) for x in leaves))


def check_dag_k1_parity(device, k=DAG_K, n=DAG_N):
    """K1 at the folded block that each of observe_dag's sweeps launches,
    (8 x k, GRID, n), through the stacked (S, K, N) entry, in both modes."""
    import torch
    from repro_torch.core.moments import BetaParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.posterior_grid import posterior_grid_plain

    worst = 0.0
    stack = lambda x: x.reshape(8, k, *x.shape[1:])
    for sym in (True, False):
        args = fleet_case(8 * k, GRID, n, seed=500, device=device, zero_cols=not sym)
        grid, t, f, mask, mu, lam, alpha, beta, aa, ab, ba, bb = args
        got = ops.posterior_grid_fleet(
            grid, stack(t), stack(f), stack(mu), stack(lam), stack(alpha), stack(beta),
            BetaParams(stack(aa), stack(ab)), BetaParams(stack(ba), stack(bb)), stack(mask),
            symmetric_grid=sym)
        want = posterior_grid_plain(*args, symmetric_grid=sym)
        if device != "cpu":
            torch.cuda.synchronize()
        err, rel = assert_logp_close(got.reshape(8 * k, 2, GRID), want)
        worst = max(worst, err)
        say(f"[dag] K1 {'mirrored' if sym else 'general '} through the stacked entry at (S, K, N) = "
            f"(8, {k}, {n}), G={GRID}: max|err| {err:.3e}; over its row's 1 + max|logp| {rel:.3e} "
            f"within rtol {RTOL:g}")
    return worst


def phase_dag(device="cuda", k=DAG_K, n=DAG_N, mc=DAG_MC, diamond_mc=200_000):
    """Slice 6's main path: observe_dag -> propose_dag -> quantize_dag_fractions
    on the 8-stage stochastic DAG, then its quality on the simulator.

    ``device="cpu"`` with a small ``k``, ``n`` and ``mc`` rehearses it
    without a card (no sync check, no device clocks)."""
    import numpy as np
    import torch
    import pipeline_dag_torch
    from repro_torch import kernels, sched, sim
    from repro_torch.device import no_sync
    from repro_torch.sched import quantize as refine

    on_card = device != "cpu"

    k1_err = check_dag_k1_parity(device, k, n)
    det, sto = dag_topology(k)
    truth = dag_truth(k, device)
    live = sto.stage_live(device)
    live_np = live.cpu().numpy() > 0
    uniform = sched.uniform_fractions(sto, device)
    budget = 0.5 * float(sched.dag_stats(sto, uniform, truth, num_points=512).var)
    # The proposal floor at one microbatch in 8K, as phase 9: the default
    # 5e-3 x 512 > 1 would force the uniform split.
    config = sched.SchedulerConfig(objective=sched.Objective.variance_budget(budget),
                                   n_iters=SWEEPS, grid_size=GRID, num_points=512,
                                   opt_steps=200, min_fraction=1.0 / (8 * k))
    # Each stage is rounded to 8K microbatches by largest remainder, without
    # the objective's move refinement: an end-to-end variance budget gives
    # no per-stage objective to refine against, and refining each stage on
    # E[t] walked 512 moves a stage away from the budgeted split (PERF.md).
    # The refinement runs once below.
    total = 8 * k
    gen = torch.Generator(device=device).manual_seed(2017)

    def telemetry(fracs):
        # n jobs per worker, sizes e^[-2, 2] around its share (dead columns
        # work a benign 1/K share; observe_dag masks them)
        share = torch.where(live > 0, fracs, 1.0 / k)[..., None]
        f = share * torch.exp(-2.0 + 4.0 * torch.rand((8, k, n), generator=gen, device=device))
        eps = torch.randn((8, k, n), generator=gen, device=device)
        t = f ** truth.alpha[..., None] * truth.mu[..., None] + \
            f ** truth.beta[..., None] * truth.sigma[..., None] * eps
        return sched.Telemetry(fracs=f, times=t)

    state = sched.init_dag(config, sto, seed=0, device=device)
    fracs = uniform
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for c in range(CYCLES):
        telem = telemetry(fracs)

        def observe_and_propose():
            with no_sync(device):
                st, ll = sched.observe_dag(state, telem, config, dag=sto)
                fr, stats = sched.propose_dag(st, sto, config)
            return st, ll, fr, stats

        (state, ll, fracs, stats), ms_cycle = clock(device, observe_and_propose)
        counts, ms_quant = clock(device, lambda: sched.quantize_dag_fractions(
            fracs.cpu().numpy(), total, live=live_np))
        fr = fracs.cpu().numpy()
        if not bool(torch.isfinite(ll[live > 0]).all()):
            raise AssertionError("non-finite log-likelihood on a live worker")
        if not (np.isfinite(fr).all() and np.abs(fr.sum(-1) - 1.0).max() < 1e-4
                and (fr[~live_np] == 0).all() and (fr[live_np] > 0).all()):
            raise AssertionError(f"stage splits not finite, not on the simplex, or dead columns "
                                 f"not 0: row sums {fr.sum(-1)}")
        if not ((counts.sum(-1) == total).all() and (counts[~live_np] == 0).all()
                and (counts[live_np] >= 1).all()):
            raise AssertionError(f"counts {counts.sum(-1)} per stage, not {total}, or a dead "
                                 f"column got work")
        say(f"[dag] cycle {c}: observe_dag + propose_dag {ms_cycle:.1f} ms (sync-free), "
            f"quantize_dag_fractions {ms_quant:.1f} ms, E[t] {float(stats.e_t):.5f} "
            f"Var {float(stats.var):.6f} (budget {budget:.6f})")
    launches = kernels.launch_counts()

    # Each step on its own, on the final beliefs (after the launch count).
    def guarded(fn):
        with no_sync(device):
            return fn()

    telem = telemetry(fracs)
    _, ms_observe = clock(device, lambda: guarded(lambda: sched.observe_dag(state, telem, config, dag=sto)))
    (f_det, _), ms_det = clock(device, lambda: guarded(lambda: sched.propose_dag(state, det, config)))
    (f_sto, _), ms_sto = clock(device, lambda: guarded(lambda: sched.propose_dag(state, sto, config)))
    rounded, ms_quant = clock(device, lambda: sched.quantize_dag_fractions(
        f_sto.cpu().numpy(), total, live=live_np))
    # The move refinement (quantize_fractions(params=)) at this width, once,
    # as a yardstick: one pass, at most 128 moves a stage, one device read a
    # block of moves; each stage refines its own E[t] under the truth.
    refine.reset_refine_stats()
    refined, ms_refine = clock(device, lambda: sched.quantize_dag_fractions(
        f_sto.cpu().numpy(), total, truth, refine_passes=1, live=live_np))
    refine_moves = refine.refine_stats()
    if not ((refined.sum(-1) == total).all() and (refined[~live_np] == 0).all()
            and (refined[live_np] >= 1).all()):
        raise AssertionError(f"refined counts {refined.sum(-1)} per stage, not {total}, or a "
                             f"dead column got work")
    moves = refine_moves["accepted"]
    if moves < int(np.abs(refined - rounded).sum()) // 2:  # each move shifts one microbatch
        raise AssertionError(f"{moves} accepted moves cannot give counts that far apart")
    # Quality at the true parameters: one sampled world for every split.
    price = lambda f: sim.simulate_workflow(7, sto, f, truth, num_samples=mc, device=device)
    t_sto, ms_sim = clock(device, lambda: price(f_sto))
    t_det, t_uni = price(f_det), price(uniform)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    e_sto, e_det, e_uni = float(t_sto.mean()), float(t_det.mean()), float(t_uni.mean())
    d_uni, d_det = t_uni - t_sto, t_det - t_sto
    se = lambda d: float(d.std()) / len(d) ** 0.5
    if not e_sto < e_uni:
        raise AssertionError(f"learned split E[t] {e_sto:.5f} not below the uniform split's {e_uni:.5f}")
    # Where the deterministic-assumption split goes: the workers believed at
    # mu <= 0 (a stage solve ranks them fastest), and the same split made
    # from the truth instead of the beliefs (params=).
    beliefs = sched.stage_params(state)
    negative = ((beliefs.mu <= 0) & (live > 0)).to(f_det.dtype)
    f_det_truth, _ = sched.propose_dag(state, det, config, params=truth)
    e_det_truth = float(price(f_det_truth).mean())
    analytic = sched.dag_stats(sto, f_sto, truth, num_points=config.num_points)
    a_e, a_v, s_v = float(analytic.e_t), float(analytic.var), float(t_sto.var(correction=0))
    say(f"[dag] S=8 K={k} N={n} (S K = {8 * k}): observe_dag {ms_observe:.1f} ms, propose_dag "
        f"deterministic {ms_det:.1f} ms, stochastic {ms_sto:.1f} ms (joint refinement included), "
        f"quantize_dag_fractions {ms_quant:.1f} ms, simulate_workflow ({len(t_sto)} samples) "
        f"{ms_sim:.1f} ms, peak device memory {peak / 2**20:.1f} MiB")
    say(f"[dag] quantize_dag_fractions with the move refinement (params=, one pass): "
        f"{ms_refine:.1f} ms for {moves} accepted moves over 8 stages "
        f"({refine_moves['evaluated']} run in blocks of {refine._MOVES_PER_READ}, "
        f"{refine_moves['reads']} device reads)"
        f"{f', {ms_refine / moves:.2f} ms an accepted move' if moves else ''}"
        f", {ms_refine / max(refine_moves['evaluated'], 1):.2f} ms a move run")
    say(f"[dag] E[t] on the simulator under the truth (common random numbers, {len(t_sto)} "
        f"samples): learned {e_sto:.5f}, uniform {e_uni:.5f} (uniform - learned {float(d_uni.mean()):.5f}"
        f" +- {se(d_uni):.5f} s.e.), deterministic-assumption {e_det:.5f} (minus the "
        f"stochastic-aware split: {float(d_det.mean()):+.5f} +- {se(d_det):.5f} s.e.)")
    say(f"[dag] {int(negative.sum())} live workers believed at mu <= 0 take "
        f"{float((f_det * negative).sum(-1).mean()):.4f} of a stage's work in the "
        f"deterministic-assumption split, {float((f_sto * negative).sum(-1).mean()):.4f} in the "
        f"stochastic-aware one; the deterministic-assumption split made from the truth "
        f"(params=): E[t] {e_det_truth:.5f} on the simulator")
    fast = (torch.arange(k, device=device) < k // 2).to(f_det.dtype)
    stage_e = lambda f: sched.dag_stats(sto, f, truth, num_points=config.num_points).stage_e
    row = lambda x: "[" + " ".join(f"{float(v):.3f}" for v in x) + "]"
    for name, f in (("uniform", uniform), ("deterministic-assumption", f_det),
                    ("stochastic-aware", f_sto), ("deterministic from the truth", f_det_truth)):
        say(f"[dag] {name} split, stage by stage: E under the truth {row(stage_e(f))}, share on "
            f"the fast-noisy half {row((f * fast).sum(-1))}")
    ratio = lambda x, y, m: float(torch.median((x / y)[(m > 0) & (live > 0)]))
    say(f"[dag] beliefs over the truth (median over live workers): mu {ratio(beliefs.mu, truth.mu, fast):.3f}"
        f" fast-noisy, {ratio(beliefs.mu, truth.mu, 1 - fast):.3f} slow-precise; sigma "
        f"{ratio(beliefs.sigma, truth.sigma, fast):.3f} fast-noisy, "
        f"{ratio(beliefs.sigma, truth.sigma, 1 - fast):.3f} slow-precise")
    say(f"[dag] learned split, analytic composition against the simulator: E[t] {a_e:.5f} vs "
        f"{e_sto:.5f} ({100 * (a_e / e_sto - 1):+.2f} %, the reference's in-tree tolerance "
        f"{100 * DAG_TOL['mean']:.1f} %), Var {a_v:.6f} vs {s_v:.6f} ({100 * (a_v / s_v - 1):+.2f} %, "
        f"tolerance {100 * DAG_TOL['var']:.0f} %; the fan-outs share ancestors, where the PERT max "
        f"is approximate: not asserted)")
    say(f"[dag] launches on the main path: {launches}")

    diamond = pipeline_dag_torch.stochastic_diamond(device, diamond_mc)
    if not (diamond["gap_det"] > 0.0 and diamond["gap_uniform"] > 0.0):
        raise AssertionError(f"examples/pipeline_dag_torch.py's diamond: {diamond}")
    say(f"[dag] examples/pipeline_dag_torch.py's diamond on {device}: the stochastic-aware split "
        f"beats the deterministic-assumption one by {diamond['gap_det']:+.4f} (+- "
        f"{diamond['se_det']:.4f} s.e.) and the uniform one by {diamond['gap_uniform']:+.4f}")
    return launches, k1_err


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def clock(device, fn):
    """``fn()`` and its milliseconds on the host's clock, the device
    synchronised before and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def phase_example(device="cuda"):
    """Phase 12: the example's body on full-width tinyllama-1.1b; its
    rounds, counters, oracle makespans and tail-mode splits printed and
    checked.  Returns (launches, the example's result, cfg)."""
    import numpy as np
    import serve_partitioned_torch as example
    from repro_torch import kernels, sched
    from repro_torch.configs import get_arch

    cfg = get_arch(TINYLLAMA[0])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = example.serve_partitioned(cfg, device)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    c = out["counters"]
    for i, r in enumerate(out["rounds"]):
        say(f"[example] round {i}: requests {r['counts'].tolist()}, drift {r['drift']:.4f}, "
            f"proposed {r['proposed']}")
    say(f"[example] {cfg.name} at full width ({cfg.num_layers} layers, d_model {cfg.d_model}) "
        f"on {device}: {seconds:.1f} s, {c}")
    say(f"[example] oracle makespan: equal split {out['oracle_equal']:.4f} s, learned split "
        f"{out['oracle_learned']:.4f} s ({np.round(out['fractions'], 4).tolist()})")
    _, same = sched.propose(out["state"], sched.SchedulerConfig(objective=sched.Objective.mean()))
    say(f"[example] risk-averse split {np.round(out['risk_fractions'], 4).tolist()}: E "
        f"{out['risk_e_t']:.4f} s, Var {out['risk_var']:.5f} (min-mean: published Var "
        f"{out['var']:.5f}, on the same beliefs {float(same.var):.5f})")
    say(f"[example] deadline {out['eps']:.4f} s split "
        f"{np.round(out['deadline_fractions'], 4).tolist()}: P(t <= eps) {out['deadline_p']:.4f}")
    if not out["oracle_learned"] < out["oracle_equal"]:
        raise AssertionError("[example] the learned split does not beat the equal split")
    if not c["drains"] > c["proposes"] >= 1:
        raise AssertionError(f"[example] not drains > proposes >= 1: {c}")
    if not (out["risk_var"] <= out["var"] and out["risk_var"] <= float(same.var)):
        raise AssertionError("[example] the risk-averse split's Var exceeds the min-mean split's")
    if not 0.0 < out["deadline_p"] <= 1.0:
        raise AssertionError(f"[example] P(t <= eps) = {out['deadline_p']} outside (0, 1]")
    for r in out["rounds"]:
        tokens = r["tokens"]
        if tokens.shape != (int(r["counts"][0]), 1) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"[example] tokens {tuple(tokens.shape)} out of shape or range")
    say(f"[example] launches on the main path: {launches}")
    return launches, out, cfg


def phase_example_parity(out, cfg):
    """K1 and K2 against their plain versions at the shapes phase 12 gave
    them: K1 at (3 replicas, G 128, ring 8) in both modes; K2 at every batch
    replica 0 served, (B, 32, 4, 64, 16 rows), at the lengths of the two
    decode steps, with a float32 and a bfloat16 query (2e-5, 1e-3) over the
    float32 cache.  Returns each kernel's max |err|."""
    import serve_partitioned_torch as example
    import torch
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
    from repro_torch.kernels.posterior_grid import posterior_grid_fleet, posterior_grid_plain

    errs = dict(posterior_grid_fleet=0.0, decode_attention=0.0)
    config = out["config"]
    k, g, n = 3, config.sched.grid_size, config.capacity
    for sym in (True, False):
        args = fleet_case(k, g, n, seed=500, device="cuda")
        err, rel = assert_logp_close(posterior_grid_fleet(*args, symmetric_grid=sym),
                                     posterior_grid_plain(*args, symmetric_grid=sym))
        errs["posterior_grid_fleet"] = max(errs["posterior_grid_fleet"], err)
        say(f"[example-parity] K1 {'mirrored' if sym else 'general '} K={k} G={g} N={n}: max|err| "
            f"{err:.3e}; over its row's 1 + max|logp| {rel:.3e} within rtol {RTOL:g}")
    lengths = [example.PROMPT + step for step in range(1, example.DECODE_STEPS + 1)]
    for i, b in enumerate(sorted({int(r["counts"][0]) for r in out["rounds"]})):
        shape = (b, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, example.CACHE)
        for q_dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-3)):
            args = decode_case(*shape, seed=520 + i, q_dtype=q_dt, kv_dtype=torch.float32,
                               length=[lengths[j % len(lengths)] for j in range(b)])
            err = assert_close(decode_attention(*args), decode_attention_plain(*args), tol, tol)
            errs["decode_attention"] = max(errs["decode_attention"], err)
            say(f"[example-parity] K2 (B, H, KVH, D, S)={shape} q {q_dt} cache float32 lengths "
                f"{sorted(set(args[3].tolist()))}: max|err| {err:.3e} within {tol:g}")
    torch.cuda.synchronize()
    return errs


CKPT_DIR = ROOT / "build" / "checkpoint"  # git-ignored; emptied first
CKPT_TICKS = 2  # ticks of both loops after the restore


def first_difference(got, want):
    """The first key path at which two checkpoint trees are not bitwise
    equal, a generator's state included; None where every leaf is."""
    import torch
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    state = lambda x: x.get_state() if isinstance(x, torch.Generator) else x
    gp, gl = _flatten_with_paths(got)
    wp, wl = _flatten_with_paths(want)
    if gp != wp:
        return "the key paths"
    for path, g, w in zip(gp, gl, wl):
        g, w = state(g), state(w)
        if g.dtype != w.dtype or g.device != w.device or not torch.equal(g, w):
            return path
    return None


def equal_leaves(what, got, want):
    """Every leaf of two checkpoint trees bitwise equal; returns their count."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    path = first_difference(got, want)
    if path is not None:
        raise AssertionError(f"{what}: {path} differs")
    return len(_flatten_with_paths(got)[0])


def phase_checkpoint(loop):
    """Phase 13: checkpoint and resume of phase 9 (e)'s dense service at
    K = 100 000 with telemetry left buffered; nothing is pending (each of
    its ticks polled its async solve in).  The restored loop and the saved
    one tick twice on the same telemetry and publish, and every leaf stays
    bitwise equal; then the scheduler state alone: saved, restored, and
    observe -> propose on both, bitwise.  Returns the launches of the ticks,
    observes and proposes that follow the restores."""
    import shutil

    import numpy as np
    import torch
    from repro_torch import kernels, sched, serve
    from repro_torch.checkpoint import CheckpointManager

    device, k = loop.device, loop.num_workers
    fracs, times = service_truth(k, device, seed=13)
    for _ in range(SVC_RING // 2):  # left buffered
        loop.push(fracs, times())
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    mgr = CheckpointManager(str(CKPT_DIR), keep=2)
    sync(device)
    t0 = time.perf_counter()
    mgr.save(1, loop.state._asdict(), {"phase": 13})
    t_save = time.perf_counter()
    mgr.wait()
    t_wait = time.perf_counter()
    nbytes = sum(p.stat().st_size for p in (CKPT_DIR / "step_00000001").iterdir())
    template = serve.init(loop.config, k, seed=0, device=device)._asdict()
    if first_difference(template, loop.state._asdict()) is None:  # the comparison can fail
        raise AssertionError("[checkpoint] a fresh template already equals the saved state")
    sync(device)
    t1 = time.perf_counter()
    restored, extra = mgr.restore(template)
    sync(device)
    t_restore = time.perf_counter() - t1
    state2 = serve.ServeState(**restored)
    n = equal_leaves("restored service state", state2, loop.state)
    say(f"[checkpoint] service state K={k} G={loop.config.sched.grid_size} ring "
        f"{loop.config.capacity} ({int(loop.state.ring.count)} rows buffered), {n} leaves: "
        f"{nbytes} bytes written; save blocks the host {(t_save - t0) * 1e3:.2f} ms (the "
        f"snapshot), wait() returns {(t_wait - t0) * 1e3:.2f} ms after save began; restore "
        f"{t_restore * 1e3:.2f} ms; every leaf bitwise, the generator's state included")

    kernels.reset_launch_counts()
    loop2 = serve.ServiceLoop(k, config=loop.config, state=state2)
    for tick in range(CKPT_TICKS):
        if tick:
            for _ in range(SVC_RING):
                row = times()
                loop.push(fracs, row)
                loop2.push(fracs, row)
        infos = [lp.tick() for lp in (loop, loop2)]
        for lp in (loop, loop2):
            while lp.config.async_propose and not lp.poll():
                time.sleep(1e-4)
        if infos[0].drained != infos[1].drained or infos[0].proposed != infos[1].proposed:
            raise AssertionError(f"[checkpoint] tick {tick}: {infos[0]} against {infos[1]}")
        equal_leaves(f"service state after tick {tick}", loop2.state, loop.state)
        if not np.array_equal(loop.fractions(), loop2.fractions()):
            raise AssertionError(f"[checkpoint] tick {tick}: published splits differ")
    say(f"[checkpoint] restored and saved loops: {CKPT_TICKS} ticks each (drained "
        f"{SVC_RING // 2} then {SVC_RING}, async solves polled in), every leaf and the "
        f"published split bitwise")

    state = loop.state.sched
    mgr.save(2, state)
    mgr.wait()
    restored, _ = mgr.restore(sched.init(loop.config.sched, k, seed=0, device=device))
    equal_leaves("restored scheduler state", restored, state)
    f = fracs[:, None].expand(k, SVC_RING).contiguous()
    telem = sched.Telemetry(fracs=f, times=torch.stack([times() for _ in range(SVC_RING)], dim=1))
    s1, ll1 = sched.observe(state, telem, loop.config.sched)
    s2, ll2 = sched.observe(restored, telem, loop.config.sched)
    equal_leaves("scheduler state after observe", (s2, ll2), (s1, ll1))
    (f1, st1), (f2, st2) = (sched.propose(s, loop.config.sched) for s in (s1, s2))
    equal_leaves("propose", (f2, st2), (f1, st1))
    sync(device)
    launches = kernels.launch_counts()
    say(f"[checkpoint] scheduler state K={k}: saved, restored, observe (N={SVC_RING}) -> "
        f"propose on the restored and the saved state bitwise")
    say(f"[checkpoint] launches on the main path: {launches}")
    return launches


FT_STEPS, FT_FAIL_STEP = 8, 4  # monitored steps; the first step with failed workers
FT_SHARE, FT_SLOWDOWN = 0.01, 6.0  # of the fleet; tests/test_fault_tolerance.py:77's factor
FT_SIGMA, FT_TIMEOUT = 3.0, 1e9  # RunConfig.straggler_threshold_sigma; the trainer's timeout
COMPRESS_RATIO = 0.01  # make_compressor's default, the trainer's (src/repro/train/trainer.py:86)


def same_bits(a, b) -> bool:
    """Two float32 arrays (numpy or torch) equal bit for bit."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def phase_legacy(device="cuda", k=K_FLEET, n=N_OBS):
    """Phase 14: the legacy partitioner API (``sched.compat``) at phase 6's
    fleet.  ``HeterogeneityAwarePartitioner`` and a ``sched.Scheduler`` twin
    with the same config and seed see phase 6's truth and telemetry for
    three cycles of observe -> ``propose_fractions`` ->
    ``propose_microbatches``; every output of the two is bitwise equal.
    Both set ``min_fraction = 1 / total`` by replacing ``config`` after
    construction (the legacy constructor has no such argument): at the
    default 5e-3 any K > 200 forces the uniform split, in both packages.
    Then ``optimize_fractions`` and the legacy ``quantize_fractions``
    against the functions they delegate to, and the ``risk_aversion``
    property.  Returns what phase 15 continues from."""
    import warnings

    import torch
    from repro_torch import kernels, sched
    from repro_torch.sched import compat

    total = 8 * k
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        part = compat.HeterogeneityAwarePartitioner(k, seed=0, device=device)
    if not any(issubclass(w.category, DeprecationWarning)
               and "repro_torch.sched.Scheduler" in str(w.message) for w in caught):
        raise AssertionError(f"[legacy] no DeprecationWarning on construction: {caught}")
    config = sched.SchedulerConfig()
    if part.config != config:
        raise AssertionError(f"[legacy] legacy defaults {part.config} != {config}")
    twin = sched.Scheduler(k, config=config, seed=0, device=device)
    for p in (part, twin):
        p.config = dataclasses.replace(p.config, min_fraction=1.0 / total)
    truth, gen = fleet_truth(device, k)

    fracs = torch.full((k,), 1.0 / k, device=device)
    kernels.reset_launch_counts()
    for c in range(CYCLES):
        telem = fleet_telemetry(truth, fracs, gen, n)
        out, ms = {}, {}
        for name, p in (("legacy", part), ("twin", twin)):
            _, ms["observe"] = clock(device, lambda: p.observe(compat.WorkerTelemetry(*telem)))
            proposal, ms["propose"] = clock(device, p.propose_fractions)
            counts, ms["microbatches"] = clock(device, lambda: p.propose_microbatches(total))
            out[name] = (*proposal, counts)
            if name == "legacy":
                ms_legacy = dict(ms)
        (fr, e_t, var, counts), (fr2, e_t2, var2, counts2) = out["legacy"], out["twin"]
        if not (same_bits(fr, fr2) and e_t == e_t2 and var == var2 and (counts == counts2).all()):
            raise AssertionError(f"[legacy] cycle {c}: the wrapper and its twin differ")
        if counts.sum() != total or counts.min() < 1 or abs(float(fr.sum()) - 1.0) > 1e-4:
            raise AssertionError(f"[legacy] cycle {c}: fractions or counts off")
        say(f"[legacy] cycle {c}: observe {ms_legacy['observe']:.1f} ms, propose_fractions "
            f"{ms_legacy['propose']:.1f} ms, propose_microbatches({total}) "
            f"{ms_legacy['microbatches']:.1f} ms (propose + quantize), E[t] {e_t:.5f}; "
            f"fractions, E[t], Var and counts bitwise the twin's")
        fracs = torch.as_tensor(fr, device=device)
    launches = kernels.launch_counts()
    gap, (s_uni, s_prop, s_orc) = oracle_gap(truth, fracs, part.config)
    say(f"[legacy] E[t] under the truth: uniform {s_uni:.5f}, proposed {s_prop:.5f}, oracle "
        f"{s_orc:.5f}: oracle gap recovered {100 * gap:.1f} %")

    (of, oe, ov), ms_opt = clock(device, lambda: compat.optimize_fractions(truth, risk_aversion=0.0))
    sf, stats = sched.solve_fractions(truth, objective=sched.Objective.mean(), steps=300)
    if not (same_bits(of, sf) and same_bits(oe, stats.e_t) and same_bits(ov, stats.var)):
        raise AssertionError("[legacy] optimize_fractions differs from solve_fractions")
    params = part.unit_params()
    legacy_q, ms_q = clock(device, lambda: compat.quantize_fractions(fr, total, params, 2.0))
    want_q = sched.quantize_fractions(fr, total, params, objective=sched.Objective.mean_var(2.0))
    if not (legacy_q == want_q).all():
        raise AssertionError("[legacy] quantize_fractions differs from sched.quantize_fractions")
    part.risk_aversion = 2.0
    if part.risk_aversion != 2.0 or part.config.objective != sched.Objective.mean_var(2.0):
        raise AssertionError(f"[legacy] risk_aversion set to 2.0 reads {part.config.objective}")
    part.risk_aversion = 0.0
    if part.config != twin.config:
        raise AssertionError("[legacy] the twins' configs differ after risk_aversion = 0")
    say(f"[legacy] optimize_fractions(truth) {ms_opt:.1f} ms, bitwise solve_fractions(steps=300); "
        f"quantize_fractions(.., {total}, params, 2.0) {ms_q:.1f} ms, bitwise the mean-variance "
        f"objective's; risk_aversion read and replaced")
    say(f"[legacy] launches on the main path (both partitioners): {launches}")
    return dict(part=part, twin=twin, truth=truth, gen=gen, fracs=fr, n=n), launches, gap


def phase_fault_tolerance(ctx):
    """Phase 15: ``FaultToleranceMonitor`` around phase 14's two
    partitioners, warmed bitwise twins.  Each step every worker runs one
    job at its share of phase 14's last proposal, drawn from the truth; 1 %
    of the fleet runs 6x slow throughout, and from step 4 another 1 %
    reports ``inf`` to monitor A, the finite times they would have had to
    monitor B.  Then A evicts the failures, admits as many fresh workers,
    and one observe at the degraded truth must shift work off the
    stragglers.  Returns that observe's launches."""
    import math

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.frontier import UnitParams
    from repro_torch.distributed.fault_tolerance import FaultToleranceMonitor

    part, twin, truth, gen, fracs = (ctx[key] for key in ("part", "twin", "truth", "gen", "fracs"))
    device, k = part.device, part.num_workers
    n_bad = math.ceil(FT_SHARE * k)
    perm = torch.randperm(k, generator=gen, device=device).cpu().numpy()
    slow, dead = np.sort(perm[:n_bad]), np.sort(perm[n_bad:2 * n_bad])
    is_slow, is_dead = np.isin(np.arange(k), slow), np.isin(np.arange(k), dead)
    mon_a, mon_b = (FaultToleranceMonitor(p, heartbeat_timeout=FT_TIMEOUT, straggler_sigma=FT_SIGMA)
                    for p in (part, twin))
    f = torch.as_tensor(fracs, device=device)
    live = torch.as_tensor(np.flatnonzero(~is_dead), device=device)
    gone = torch.as_tensor(dead, device=device)
    expected, step_ms, false_pos = [], [], []
    for step in range(FT_STEPS):
        times = fleet_times(truth, f, gen).cpu().numpy()
        times[slow] *= FT_SLOWDOWN
        seen = times.copy()
        if step >= FT_FAIL_STEP:
            seen[dead] = np.inf
        out_a, ms = clock(device, lambda: mon_a.observe_step(fracs, seen, now=float(step)))
        out_b = mon_b.observe_step(fracs, times, now=float(step))
        step_ms.append(ms)
        failed = is_dead if step >= FT_FAIL_STEP else np.zeros(k, bool)
        if not (np.array_equal(out_a["failures"], failed) and not out_b["failures"].any()):
            raise AssertionError(f"[fault] step {step}: failure masks differ from the injected set")
        if (out_a["stragglers"] & failed).any():
            raise AssertionError(f"[fault] step {step}: a failed worker was flagged as a straggler")
        ewma_a, ewma_b = part.state.ewma_ll, twin.state.ewma_ll
        if not same_bits(ewma_a[live], ewma_b[live]):
            raise AssertionError(f"[fault] step {step}: live workers' ewma_ll differ from the twin's")
        if step == FT_FAIL_STEP - 1:
            frozen = ewma_a[gone].clone()
        elif step >= FT_FAIL_STEP and not same_bits(ewma_a[gone], frozen):
            raise AssertionError(f"[fault] step {step}: a failed worker's ewma_ll moved")
        expected += (["failure"] if failed.any() else []) + (
            ["straggler"] if out_a["stragglers"].any() else [])
        healthy = ~is_slow & ~failed
        fp = int((out_a["stragglers"] & healthy).sum())
        false_pos.append(f"{fp}/{int(healthy.sum())}")
        say(f"[fault] step {step}: {ms:.1f} ms; failures {int(out_a['failures'].sum())}, "
            f"stragglers flagged {int(out_a['stragglers'][slow].sum())} of {n_bad}, false "
            f"positives {fp} of {int(healthy.sum())} healthy ({100 * fp / healthy.sum():.3f} %)")
    recall = float(out_a["stragglers"][slow].mean())
    if recall != 1.0:
        raise AssertionError(f"[fault] straggler recall {recall} at step {FT_STEPS - 1}")

    failures = out_a["failures"]
    _, ms_evict = clock(device, lambda: mon_a.evict(failures))
    if part.num_workers != k - n_bad or len(mon_a.health) != k - n_bad:
        raise AssertionError(f"[fault] {part.num_workers} workers after evicting {n_bad}")
    _, ms_admit = clock(device, lambda: mon_a.admit(n_bad, seed=1))
    if part.num_workers != k or len(mon_a.health) != k:
        raise AssertionError(f"[fault] {part.num_workers} workers after admitting {n_bad}")
    types = [e["type"] for e in mon_a.events]
    if types != expected + ["evict", "admit"] or mon_a.events[-2:] != [
            {"type": "evict", "count": n_bad}, {"type": "admit", "count": n_bad}]:
        raise AssertionError(f"[fault] events {types} != {expected + ['evict', 'admit']}")
    if any(e["workers"] != dead.tolist() for e in mon_a.events if e["type"] == "failure"):
        raise AssertionError("[fault] a failure event names other workers")

    # Survivors keep their order (remove_workers compacts the fleet); the
    # admitted are the failed machines, repaired, at the end.
    keep = np.flatnonzero(~is_dead)
    order = torch.as_tensor(np.concatenate([keep, dead]), device=device)
    factor = torch.as_tensor(np.where(is_slow, FT_SLOWDOWN, 1.0), dtype=torch.float32, device=device)
    degraded = UnitParams(mu=(truth.mu * factor)[order], sigma=(truth.sigma * factor)[order],
                          alpha=truth.alpha[order], beta=truth.beta[order])
    slow_now, admitted = np.searchsorted(keep, slow), np.arange(k - n_bad, k)
    shares = np.concatenate([fracs[keep], np.full(n_bad, 1.0 / k, np.float32)])
    telem = fleet_telemetry(degraded, torch.as_tensor(shares / shares.sum(), device=device), gen,
                            ctx["n"])
    kernels.reset_launch_counts()
    (_, (fr, _, _)), ms_close = clock(device, lambda: (part.observe(telem), part.propose_fractions()))
    launches = kernels.launch_counts()
    before, after = float(fracs[slow].sum()), float(fr[slow_now].sum())
    if not (np.isfinite(fr).all() and abs(float(fr.sum()) - 1.0) <= 1e-4):
        raise AssertionError(f"[fault] fractions after readmission not finite or sum {fr.sum()}")
    if not (fr[admitted] > 0).all():
        raise AssertionError("[fault] an admitted worker got no work")
    if not after < before:
        raise AssertionError(f"[fault] the stragglers' share did not fall: {before} -> {after}")
    say(f"[fault] K={k}: observe_step median {statistics.median(step_ms):.1f} ms of {FT_STEPS}; "
        f"failures exact from step {FT_FAIL_STEP}, none flagged a straggler; straggler recall "
        f"{recall:.1f}; live ewma_ll bitwise the failure-free twin's, failed workers' frozen; "
        f"false positives by step {false_pos}")
    say(f"[fault] evict {n_bad} {ms_evict:.1f} ms -> K={k - n_bad}, admit {n_bad} {ms_admit:.1f} "
        f"ms -> K={k}; events {len(types)} in order; observe (N={ctx['n']}) at the degraded truth "
        f"+ propose_fractions {ms_close:.1f} ms")
    say(f"[fault] the stragglers' share: {before:.6f} before they slowed, {after:.6f} after "
        f"(x{after / before:.3f}); admitted workers' least fraction {float(fr[admitted].min()):.3e}")
    say(f"[fault] launches on the main path: {launches}")
    return launches


def check_compressed(kind, grads, ef, sent, new_ef, ratio):
    """Every leaf: sent + ef' == g + ef (rtol, atol 1e-5, tests/test_runtime.py's);
    int8: sent is integers in [-127, 127] times the leaf's scale; topk: at
    least k entries kept, more only by ties.  Returns the densest leaf's
    density (topk) or 0."""
    import torch
    from repro_torch.models.params import leaves

    densest = 0.0
    for g, e, s, e2 in zip(*(leaves(t) for t in (grads, ef, sent, new_ef))):
        want = g.to(torch.float32) + e
        if float(torch.max(torch.abs((s + e2) - want) - 1e-5 * torch.abs(want))) > 1e-5:
            raise AssertionError(f"[compress] {kind}: sent + ef' != g + ef on a {tuple(g.shape)} leaf")
        if kind == "int8_ef":
            scale = torch.max(torch.abs(want)) / 127.0 + 1e-12
            q = torch.round(s / scale)
            if not (torch.equal(q * scale, s) and float(q.abs().max()) <= 127):
                raise AssertionError(f"[compress] int8: a {tuple(g.shape)} leaf is not int8 x scale")
        else:
            k = max(int(g.numel() * ratio), 1)
            kept = s != 0
            nnz, least = int(kept.sum()), torch.min(torch.abs(want[kept]))
            above, at_least = (int((torch.abs(want) > least).sum()),
                               int((torch.abs(want) >= least).sum()))
            if not (nnz >= k and above < k and at_least == nnz):
                raise AssertionError(f"[compress] topk: {nnz} kept of {g.numel()} (k {k}, "
                                     f"{above} above the least kept)")
            densest = max(densest, nnz / g.numel())
    return densest


def phase_compression(device="cuda", cfg=None):
    """Phase 16: gradient compression with error feedback over full-width
    tinyllama-1.1b's parameter tree (1.100 B float32 entries) drawn from a
    seeded generator: both schemes at the trainer's ratio, two chained
    calls each, every leaf checked; then the embedding, the stacked q
    projection and the final norm's scale compressed on the card and on
    the CPU, bit for bit."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.compression import make_compressor
    from repro_torch.models import model_zoo
    from repro_torch.models.params import leaves, tree_map

    cfg = cfg or get_arch(TINYLLAMA[0])
    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(16)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=device),
                     model_zoo.model_spec(cfg))
    numel, n_leaves = sum(g.numel() for g in leaves(grads)), len(leaves(grads))
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    pick = lambda t: dict(embed=t["embed"], wq=t["cycles"][0]["attn"]["wq"],
                          norm=t["final_norm"]["scale"])
    for kind in ("int8_ef", "topk_ef"):
        compress, init_ef = make_compressor(kind, None, ratio=COMPRESS_RATIO)
        ef = init_ef(grads)
        for call in range(2):
            (sent, new_ef), ms = clock(device, lambda: compress(grads, ef))
            densest = check_compressed(kind, grads, ef, sent, new_ef, COMPRESS_RATIO)
            say(f"[compress] {kind} call {call}: {ms:.1f} ms over {numel} entries in {n_leaves} "
                f"leaves; sent + ef' == g + ef on every leaf"
                + (f"; densest leaf {densest:.6f}" if kind == "topk_ef" else "; int8 x scale"))
            del sent
            ef = new_ef
        sub_g, sub_e = pick(grads), pick(ef)
        on_dev = compress(sub_g, sub_e)
        cpu = lambda t: {key: x.cpu() for key, x in t.items()}
        on_cpu = compress(cpu(sub_g), cpu(sub_e))
        for part, got, want in zip(("sent", "ef"), on_dev, on_cpu):
            for key in sub_g:
                if not same_bits(got[key].cpu(), want[key]):
                    raise AssertionError(f"[compress] {kind}: {part} of {key} on {device} != the CPU's")
        say(f"[compress] {kind}: embed {tuple(sub_g['embed'].shape)}, wq "
            f"{tuple(sub_g['wq'].shape)} and the final norm's scale on {device} bitwise the CPU's")
        del ef, on_dev, on_cpu
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    say(f"[compress] int8 payload {numel + 4 * n_leaves} bytes (a scale a leaf) against float32's "
        f"{4 * numel}; peak device memory {peak / 2**30:.2f} GiB (the tree is "
        f"{4 * numel / 2**30:.2f} GiB)")


# Phase 17: the trainer on full-width tinyllama-1.1b (RunConfig's defaults
# but these; launch/train.py's four simulated workers).
TRAIN_ARCH, TRAIN_STEPS, TRAIN_WARM = "tinyllama-1.1b", 32, 2
TRAIN_RUN = dict(warmup_steps=3, partitioner_refit_every=16, grad_compression="int8_ef")
TRAIN_SHAPE = dict(seq_len=512, global_batch=16)
# phase 17's microbatch tiled to these rows (of 512 tokens) for the remat
# settings' times where the card sets them
REMAT_ROWS = (8, 32)
TRAIN_MB, TRAIN_WORKERS = 8, 4
TRAIN_DIR = ROOT / "build" / "train_ckpt"  # git-ignored; emptied first, removed after
# The train step on the card against the CPU, float32, TF32 off, reduced
# width: the two devices sum in different orders, ~1e-6 relative a layer.
TRAIN_PARITY = dict(loss=1e-5, moments=1e-4)  # rtol; moments: of each leaf's largest entry
TRAIN_PARITY_ARCHS = ("smollm-135m", "granite-moe-3b-a800m", "recurrentgemma-2b")
# Phase 18: python -m repro_torch.launch.train on full-width smollm-135m.
TRAIN_CLI_ARGV = ["--arch", "smollm-135m", "--full", "--seq-len", "128", "--global-batch", "16",
                  "--microbatches", "8", "--workers", "4"]
RESUME_RTOL = 1e-4  # tests/test_system.py::test_checkpoint_restart_resumes_exactly
# Phase 19: the hybrid family trained on the card.  recurrentgemma-2b at full
# width, its depth cut to 12 of 26 layers (4 whole (rglru, rglru, localattn)
# cycles, 8 RG-LRU layers; ~1.68 B parameters, as 26 would need ~104 GiB at
# phase 17's ~36 GiB a billion), phase 17's settings but 16 steps with a drain
# every 8: with one drain every 16, the only split would land after the last
# step, and the makespan could not fall.
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_STEPS = "recurrentgemma-2b", 12, 16
HYBRID_RUN = dict(TRAIN_RUN, partitioner_refit_every=8)


def phase_train_parity(device="cuda"):
    """Phase 17's preamble: three steps of ``make_train_step`` (remat
    "full", 4 microbatches, lr 1e-3 after a warmup of 1) on the card and on
    the CPU, the same seeded weights and batches, reduced smollm-135m,
    granite-moe-3b-a800m and recurrentgemma-2b (on the card its scans run
    K3 and K3's backward, on the CPU their plain versions) in float32: loss
    and grad norm at rtol 1e-5, m and v within 1e-4 of each leaf's largest
    entry.  Returns the worst relative errors."""
    import torch
    from repro_torch.configs import RunConfig, ShapeConfig, get_arch, reduced
    from repro_torch.data.pipeline import DataIterator
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    worst = dict(loss=0.0, moments=0.0)
    for arch in TRAIN_PARITY_ARCHS:
        cfg = reduced(get_arch(arch))
        run = RunConfig(model=cfg, shape=ShapeConfig("parity", 32, 8, "train"), learning_rate=1e-3,
                        warmup_steps=1, total_steps=3)
        step = make_train_step(cfg, run, ctx=ApplyCtx(mode="train", remat="full"),
                               num_microbatches=4)
        cpu_p = model_zoo.init_model_params(cfg, seed=17, device="cpu")
        dev_p = tree_map(lambda p: p.to(device), cpu_p)
        cpu_s, dev_s = adamw.init(cpu_p), adamw.init(dev_p)
        data = DataIterator(cfg.vocab_size, 32, 8, 4, seed=17)
        for s in range(3):
            batch = {k: torch.as_tensor(v) for k, v in next(data).items()}
            cpu_p, cpu_s, cm = step(cpu_p, cpu_s, batch, s)
            dev_p, dev_s, dm = step(dev_p, dev_s, {k: v.to(device) for k, v in batch.items()}, s)
            for key in ("loss", "grad_norm"):
                rel = abs(float(dm[key]) - float(cm[key])) / abs(float(cm[key]))
                worst["loss"] = max(worst["loss"], rel)
                if rel > TRAIN_PARITY["loss"]:
                    raise AssertionError(f"[train-parity] {arch} step {s} {key}: {float(dm[key])} "
                                         f"on {device}, {float(cm[key])} on the CPU")
            for got, want in zip(leaves(dev_s.m) + leaves(dev_s.v), leaves(cpu_s.m) + leaves(cpu_s.v)):
                scale = float(want.abs().max())
                rel = float((got.cpu() - want).abs().max()) / max(scale, 1e-30)
                worst["moments"] = max(worst["moments"], rel)
                if rel > TRAIN_PARITY["moments"]:
                    raise AssertionError(f"[train-parity] {arch} step {s}: a {tuple(want.shape)} "
                                         f"moment {rel:.3e} of its largest entry apart")
        say(f"[train-parity] {cfg.name}: 3 steps on {device} against the CPU, loss {float(dm['loss']):.6f} "
            f"/ {float(cm['loss']):.6f}")
    say(f"[train-parity] worst: loss and grad norm {worst['loss']:.3e} (rtol "
        f"{TRAIN_PARITY['loss']:g}), m and v {worst['moments']:.3e} of a leaf's largest entry "
        f"({TRAIN_PARITY['moments']:g})")
    return worst


def phase_train(device="cuda", cfg=None, steps=TRAIN_STEPS, shape=None, m=TRAIN_MB,
                run_kw=None, tag="train", remat_rows=REMAT_ROWS):
    """Phase 17 (and 19 with ``cfg``, ``steps``, ``run_kw`` and ``tag``):
    ``Trainer`` on full-width tinyllama-1.1b, one step a ``train(1)`` call
    timed on the host's clock (synchronised; the loss read every step, as
    the reference does); the loss and makespan conditions of
    tests/test_system.py::test_training_converges_and_rebalances; then one
    microbatch's forward and backward under each remat setting, the loss
    and gradients of "full", "dots" and "outs" bitwise those of "none"; on
    the card the same microbatch tiled to each of ``remat_rows`` rows under
    "full", "dots" and "outs", the last two bitwise "full"'s, and one more
    step under the profiler.  Returns (the launches of
    the timed steps, the trainer's K1 shape (K, G, N), one microbatch's
    launches by remat)."""
    import shutil

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeConfig, get_arch
    from repro_torch.distributed.simulated_cluster import SimulatedCluster
    from repro_torch.launch.train import simulated_fleet
    from repro_torch.models.layers import ApplyCtx
    from repro_torch.models.params import leaves
    from repro_torch.models.transformer import REMATS
    from repro_torch.train.train_step import microbatch_value_and_grad
    from repro_torch.train.trainer import Trainer
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        """Counts the PyTorch operations dispatched inside the ``with``
        block (``examples/profile_kernels_torch.py``'s counter)."""

        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    cfg = cfg or get_arch(TRAIN_ARCH)
    shape = shape or TRAIN_SHAPE
    on_card = torch.device(device).type == "cuda"
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    run = RunConfig(model=cfg, shape=ShapeConfig("phase17", kind="train", **shape),
                    total_steps=steps, checkpoint_every=10**9,  # no checkpoint of ~11 GB
                    checkpoint_dir=str(TRAIN_DIR), **(run_kw or TRAIN_RUN))
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    trainer = Trainer(run, cluster=SimulatedCluster(simulated_fleet(TRAIN_WORKERS)),
                      num_microbatches=m, device=device)
    losses, splits, makespans, ms = [], [], [], []
    for _ in range(steps):
        report, t = clock(device, lambda: trainer.train(1))
        losses += report.losses
        splits += report.splits
        makespans += report.makespans
        ms.append(t)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    n_params = sum(p.numel() for p in leaves(trainer.params))
    timed = ms[TRAIN_WARM:]
    med = statistics.median(timed)
    tokens = shape["global_batch"] * shape["seq_len"]
    say(f"[{tag}] {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} {cfg.dtype} parameters), batch {shape['global_batch']} x {shape['seq_len']} in "
        f"{m} microbatches, remat {run.remat}, {run.grad_compression}, {steps} steps on {device}")
    say(f"[{tag}] step {med:.1f} ms median ({min(timed):.1f}-{max(timed):.1f} over steps "
        f"{TRAIN_WARM + 1}-{steps}; the first two {ms[0]:.1f}, {ms[1]:.1f}), "
        f"{tokens / (med / 1e3):.0f} tokens/s, peak device memory {peak / 2**30:.2f} GiB")
    half = steps // 2
    say(f"[{tag}] every step's ms: {[round(t, 1) for t in ms]} (drains after steps "
        f"{list(range(run.partitioner_refit_every, steps + 1, run.partitioner_refit_every))})")
    say(f"[{tag}] loss at step 1 {losses[0]:.4f}, step {half} {losses[half - 1]:.4f}, step {steps} "
        f"{losses[-1]:.4f}")
    q = max(steps // 4, 1)
    first, last = float(np.mean(losses[:q])), float(np.mean(losses[-q:]))
    m_first, m_last = float(np.mean(makespans[:q])), float(np.mean(makespans[-q:]))
    say(f"[{tag}] splits {[s.tolist() for s in splits]}; mean loss first quarter {first:.4f}, last "
        f"{last:.4f}; mean makespan first quarter {m_first:.3f}, last {m_last:.3f}")
    say(f"[{tag}] launches on the main path: {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] a loss is not finite: {losses}")
    if not last < first:
        raise AssertionError(f"[{tag}] the last quarter's loss {last} is not below the first's {first}")
    if not splits:
        raise AssertionError(f"[{tag}] the partitioner proposed no split")
    if not m_last < m_first:
        raise AssertionError(f"[{tag}] the last quarter's makespan {m_last} is not below {m_first}")
    k1_shape = (TRAIN_WORKERS, trainer.partitioner.config.grid_size, trainer._ring.capacity)

    batch = {key: torch.as_tensor(v[0]).to(device) for key, v in next(trainer.data).items()}
    remat_launches, plain_out = {}, None
    for remat in REMATS:  # "none" first: the others' loss and gradients must be its bits
        vg = microbatch_value_and_grad(cfg, ApplyCtx(mode="train", remat=remat))
        kernels.reset_launch_counts()
        with CountOps() as count:
            out = vg(trainer.params, batch)  # warm; its launches are the policy's
        sync(device)
        remat_launches[remat] = kernels.launch_counts()
        if plain_out is None:
            plain_out = out
        else:
            assert_bitwise(f"[{tag}] remat {remat}'s loss and gradients",
                           [out[0][0]] + leaves(out[1]), [plain_out[0][0]] + leaves(plain_out[1]))
        del out
        if on_card:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        times = [clock(device, lambda: vg(trainer.params, batch))[1] for _ in range(3)]
        extra = (torch.cuda.max_memory_allocated() - base) if on_card else 0
        say(f"[{tag}] one microbatch ({batch['tokens'].shape[0]} x {shape['seq_len']}) forward and "
            f"backward, remat {remat}: {statistics.median(times):.1f} ms (median of 3: "
            f"{', '.join(f'{t:.1f}' for t in times)}), peak {extra / 2**30:.2f} GiB above the "
            f"{base / 2**30 if on_card else 0:.2f} GiB held; {count.n} PyTorch operations "
            f"dispatched; launches {remat_launches[remat]}")
    del plain_out
    say(f"[{tag}] remat dots and outs (and full): loss and every gradient bitwise those of none")
    if on_card and remat_rows:  # where the card, not the host, sets the time: fewer, larger
        # microbatches (the one above tiled); "none" would not fit at the largest
        for rows in remat_rows:
            big = {key: v.repeat(rows // v.shape[0], *([1] * (v.ndim - 1)))
                   for key, v in batch.items()}
            full_out = None
            for remat in ("full", "dots", "outs"):
                vg = microbatch_value_and_grad(cfg, ApplyCtx(mode="train", remat=remat))
                out = vg(trainer.params, big)
                if full_out is None:
                    full_out = out
                else:
                    assert_bitwise(f"[{tag}] remat {remat}'s loss and gradients at {rows} rows",
                                   [out[0][0]] + leaves(out[1]),
                                   [full_out[0][0]] + leaves(full_out[1]))
                del out
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                times = [clock(device, lambda: vg(trainer.params, big))[1] for _ in range(3)]
                extra = torch.cuda.max_memory_allocated() - base
                say(f"[{tag}] one microbatch of {rows} x {shape['seq_len']}, remat {remat}: "
                    f"{statistics.median(times):.1f} ms (median of 3: "
                    f"{', '.join(f'{t:.1f}' for t in times)}), peak {extra / 2**30:.2f} GiB above "
                    f"the {base / 2**30:.2f} GiB held")
            del full_out, big
            torch.cuda.empty_cache()
        say(f"[{tag}] remat dots and outs at {remat_rows} rows: bitwise full's")
    if on_card:  # where a step's time goes: one more step under the profiler (kernels only)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = clock(device, lambda: trainer.train(1))
        kern = [e for e in prof.key_averages() if e.device_time_total > 0]
        busy = sum(e.device_time_total for e in kern) / 1e3
        say(f"[{tag}] a profiled step: {wall:.1f} ms on the host's clock, {busy:.1f} ms of kernels, "
            f"the card idle {100 * (1 - busy / wall):.1f} %; {sum(e.count for e in kern)} kernels")
        for e in sorted(kern, key=lambda e: -e.device_time_total)[:8]:
            say(f"[{tag}]   {e.key[:80]}: {e.count} x, {e.device_time_total / 1e3:.1f} ms")
        for name in ("lru_scan_kernel", "lru_scan_bwd_kernel", "posterior_grid_fleet_kernel"):
            own = [e for e in kern if name + "<" in e.key]  # the port's kernels, by entry
            ms_own = sum(e.device_time_total for e in own) / 1e3
            say(f"[{tag}] {name}: {sum(e.count for e in own)} x, {ms_own:.2f} ms, "
                f"{100 * ms_own / busy:.2f} % of the kernels' time")
    del trainer
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return launches, k1_shape, remat_launches


def phase_train_hybrid(device="cuda", layers=HYBRID_LAYERS, steps=HYBRID_STEPS, shape=None):
    """Phase 19: phase 17's ``Trainer`` on recurrentgemma-2b at full width,
    the registry's config cut to ``layers`` for this call only.  Returns
    (launches, K1's shape, the cut config, one microbatch's launches by remat)."""
    from repro_torch.configs import get_arch

    cut = dataclasses.replace(get_arch(HYBRID_ARCH), num_layers=layers)
    launches, k1_shape, remat_launches = phase_train(device, cfg=cut, steps=steps, shape=shape,
                                                     run_kw=HYBRID_RUN, tag="train-hybrid",
                                                     remat_rows=())
    return launches, k1_shape, cut, remat_launches


# Phase 20: examples/train_hetero_torch.py at its full width (smollm-135m in
# float32, 8 x 64 tokens in 8 microbatches), its steps cut from 300 to 36:
# 3 refits (every 12 steps) and 3 checkpoints (every 12).
HETERO_ARGV, HETERO_WARM = ["--steps", "36"], 2
HETERO_DIR = ROOT / "build" / "hetero_ckpt"  # git-ignored; emptied first, removed after
# Phase 21: examples/elastic_failover_torch.py at its own (reduced) settings.
ELASTIC_DIR = ROOT / "build" / "failover_ckpt"


@contextlib.contextmanager
def k1_shapes():
    """Records the (K, G, N) of every K1 call made inside the block, through
    the wrapper that every scheduler path calls (``kernels.ops``); the calls
    themselves are unchanged.  Yields the set."""
    from repro_torch.kernels import ops

    seen, inner = set(), ops._posterior_grid_fleet

    def recording(grid, t, *args, **kwargs):
        seen.add((t.shape[0], grid.shape[0], t.shape[1]))
        return inner(grid, t, *args, **kwargs)

    ops._posterior_grid_fleet = recording
    try:
        yield seen
    finally:
        ops._posterior_grid_fleet = inner


def phase_train_hetero(device="cuda", argv=HETERO_ARGV):
    """Phase 20: ``train_hetero_torch.main`` on the card, every step timed
    from its start to the next one's on the host's clock (synchronised; a
    step's drain and loss read included), through a ``Trainer`` subclass
    that wraps the step function.  Checks the chip's conditions: finite
    losses, the last decile's mean loss below the first's, the last
    quarter's makespan below the first's, a split, and in the last split
    the slow worker (22 s a unit) with no more microbatches than any other.
    Returns (launches, drains, the (K, G, N) shapes K1 ran at)."""
    import shutil

    import numpy as np
    import torch
    import train_hetero_torch as hetero
    from repro_torch import kernels

    starts = []

    class Timed(hetero.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            step = self._step_fn

            def timed(*a):
                sync(device)
                starts.append(time.perf_counter())
                return step(*a)

            self._step_fn = timed

    shutil.rmtree(HETERO_DIR, ignore_errors=True)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    hetero.Trainer = Timed
    try:
        with k1_shapes() as shapes:
            rep = hetero.main([*argv, "--ckpt-dir", str(HETERO_DIR),
                               *([] if on_card else ["--device", device])])
        sync(device)
        starts.append(time.perf_counter())
    finally:
        hetero.Trainer = Timed.__bases__[0]
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    saved = sorted(p.name for p in HETERO_DIR.iterdir())
    shutil.rmtree(HETERO_DIR, ignore_errors=True)
    ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    steps = len(rep.losses)
    timed = ms[HETERO_WARM:]
    med = statistics.median(timed)
    say(f"[hetero] examples/train_hetero_torch.py {' '.join(argv)} on {device}: step {med:.1f} ms "
        f"median ({min(timed):.1f}-{max(timed):.1f} over steps {HETERO_WARM + 1}-{steps}; the "
        f"first two {ms[0]:.1f}, {ms[1]:.1f}), {8 * 64 / (med / 1e3):.0f} tokens/s, peak device "
        f"memory {peak / 2**30:.2f} GiB; checkpoints {saved}")
    say(f"[hetero] every step's ms: {[round(t, 1) for t in ms]}")
    q, k = max(steps // 10, 1), max(steps // 4, 1)
    first, last = float(np.mean(rep.losses[:q])), float(np.mean(rep.losses[-q:]))
    m_first, m_last = float(np.mean(rep.makespans[:k])), float(np.mean(rep.makespans[-k:]))
    say(f"[hetero] splits {[s.tolist() for s in rep.splits]}; loss {first:.4f} -> {last:.4f} (deciles), "
        f"makespan {m_first:.3f} -> {m_last:.3f} s (quarters); launches {launches}; K1 at "
        f"(K, G, N) {sorted(shapes)}")
    if not all(np.isfinite(rep.losses)):
        raise AssertionError(f"[hetero] a loss is not finite: {rep.losses}")
    if not last < first:
        raise AssertionError(f"[hetero] the last decile's loss {last} is not below the first's {first}")
    if not m_last < m_first:
        raise AssertionError(f"[hetero] the last quarter's makespan {m_last} is not below {m_first}")
    if not rep.splits or rep.splits[-1][3] > rep.splits[-1].min():
        raise AssertionError(f"[hetero] the slow worker is not the least loaded: {rep.splits}")
    return launches, steps // 12, shapes


def phase_elastic(device="cuda"):
    """Phase 21: ``elastic_failover_torch.main`` on the card at its own
    settings: its two asserts (mu restored bitwise, pooled <= global / 2)
    and a straggler event for worker 1, a fleet of 2, the resume at step
    48.  Returns (launches, what main returned, its seconds, the (K, G, N)
    shapes K1 ran at)."""
    import shutil

    import elastic_failover_torch as elastic
    from repro_torch import kernels

    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    kernels.reset_launch_counts()
    with k1_shapes() as shapes:
        out, ms = clock(device, lambda: elastic.main(
            ["--ckpt-dir", str(ELASTIC_DIR), *([] if device == "cuda" else ["--device", device])]))
    launches = kernels.launch_counts()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    say(f"[elastic] five phases on {device} in {ms / 1e3:.1f} s: splits {out['split1'].tolist()} -> "
        f"{out['split2'].tolist()}, straggler {out['straggler']}, fleet {out['fleet_size']}, resumed "
        f"at {out['resumed_step']} (mu {out['mu_restored'].tolist()}), loss {out['losses1'][0]:.4f} "
        f"-> {out['losses4'][-1]:.4f}; phase 5 observations {out['obs']}; launches {launches}; "
        f"K1 at (K, G, N) {sorted(shapes)}")
    if out["straggler"] is None or out["straggler"]["workers"] != [1]:
        raise AssertionError(f"[elastic] no straggler event for worker 1: {out['straggler']}")
    if out["fleet_size"] != 2 or out["resumed_step"] != 48:
        raise AssertionError(f"[elastic] fleet {out['fleet_size']}, resumed at {out['resumed_step']}")
    return launches, out, ms / 1e3, shapes


def phase_train_cli(device=None, full=True):
    """Phase 18: ``python -m repro_torch.launch.train`` in-process on
    full-width smollm-135m (16 steps, checkpoints at 8 and 16), then
    ``--resume --steps 8``, which must restore step 16; then
    tests/test_system.py::test_checkpoint_restart_resumes_exactly at this
    width on ``Trainer`` objects, with the bytes written, the ms that
    ``save`` holds the host, the ms to ``wait()`` and the restore ms.
    Returns K1 launches."""
    import shutil

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeConfig, get_arch, reduced
    from repro_torch.distributed.simulated_cluster import SimulatedCluster
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import Trainer

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    argv = TRAIN_CLI_ARGV + ["--ckpt-dir", str(TRAIN_DIR)] + (["--device", device] if device else [])
    if not full:
        argv.remove("--full")
    kernels.reset_launch_counts()
    first, s1 = clock(device or "cuda", lambda: launch_train.main(argv + ["--steps", "16"]))
    second, s2 = clock(device or "cuda", lambda: launch_train.main(argv + ["--steps", "8", "--resume"]))
    launches = kernels.launch_counts()
    say(f"[train-cli] the two calls took {s1:.0f} and {s2:.0f} ms (model init, 16 and 8 steps, "
        f"checkpoints at steps 8, 16 and 20, 24, the restore)")
    rep = second["report"]
    restored_at = rep.steps - len(rep.losses)
    say(f"[train-cli] {first['trainer'].cfg.name}: 16 steps, losses {first['report'].losses[0]:.4f} "
        f"-> {first['report'].losses[-1]:.4f}; --resume restored step {restored_at} and trained to "
        f"{rep.steps}: {[round(x, 4) for x in rep.losses]}")
    if not (second["resumed"] and restored_at == 16 and rep.steps == 24):
        raise AssertionError(f"[train-cli] resume: {second['resumed']}, from {restored_at}")
    if not all(np.isfinite(first["report"].losses + rep.losses)):
        raise AssertionError("[train-cli] a loss is not finite")
    say(f"[train-cli] launches on the main path: {launches}")
    device = first["trainer"].device
    del first, second
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    # the reference test's layout (8 sequences in 4 microbatches, warmup 2,
    # 16 steps in all) at this width, 128 tokens a sequence
    cfg = get_arch("smollm-135m") if full else reduced(get_arch("smollm-135m"))
    run = RunConfig(model=cfg, shape=ShapeConfig("resume", 128, 8, "train"), total_steps=16,
                    warmup_steps=2, checkpoint_every=10**9, checkpoint_dir=str(TRAIN_DIR))
    fleet = lambda: SimulatedCluster(launch_train.simulated_fleet(4), seed=2)
    tr1 = Trainer(run, cluster=fleet(), num_microbatches=4, device=device)
    tr1.train(8)
    _, save_ms = clock(device, tr1.save)
    _, wait_ms = clock(device, tr1.ckpt.wait)
    nbytes = sum(f.stat().st_size for f in TRAIN_DIR.rglob("*") if f.is_file())
    want = tr1.train(4).losses
    tr2 = Trainer(run, cluster=fleet(), num_microbatches=4, device=device)
    ok, restore_ms = clock(device, tr2.try_restore)
    if not (ok and tr2.step == 8):
        raise AssertionError(f"[train-cli] restore: {ok}, step {tr2.step}")
    got = tr2.train(4).losses
    worst = float(np.max(np.abs(np.asarray(got) - want) / np.abs(want)))
    say(f"[train-cli] resume at step 8: {nbytes} bytes written; save holds the host {save_ms:.1f} "
        f"ms, wait() {wait_ms:.1f} ms, restore {restore_ms:.1f} ms; 4 losses "
        f"{[round(x, 5) for x in got]} against {[round(x, 5) for x in want]}, worst rel "
        f"{worst:.3e} (rtol {RESUME_RTOL:g})")
    if not worst <= RESUME_RTOL:
        raise AssertionError("[train-cli] the resumed losses differ from the uninterrupted run's")
    del tr1, tr2
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return launches


def phase_train_k1_parity(shape):
    """K1 against its plain version at the shape the trainer gave it: its
    K workers, grid G and ring capacity N, both modes.  Returns max |err|."""
    from repro_torch.kernels.posterior_grid import posterior_grid_fleet, posterior_grid_plain

    worst = 0.0
    k, g, n = shape
    for sym in (True, False):
        args = fleet_case(k, g, n, seed=1700, device="cuda")
        err, rel = assert_logp_close(posterior_grid_fleet(*args, symmetric_grid=sym),
                                     posterior_grid_plain(*args, symmetric_grid=sym))
        worst = max(worst, err)
        say(f"[train-parity] K1 {'mirrored' if sym else 'general '} K={k} G={g} N={n}: max|err| "
            f"{err:.3e}; over its row's 1 + max|logp| {rel:.3e} within rtol {RTOL:g}")
    return worst


SHARD_STORE = ROOT / "build" / "sharding_store"  # git-ignored; the one-rank world's FileStore


def agree(what, got, want, rtol, atol=None):
    """"bitwise" when every leaf of ``got`` (a generator's state included)
    equals ``want``'s bit for bit; else every leaf within ``rtol`` (and
    ``atol``, by default ``rtol``) of ``want``'s, the generators still
    equal, and the largest |difference| is said.  Raises otherwise."""
    import torch

    pairs = list(zip(leaves(got), leaves(want), strict=True))
    if all(g.shape == w.shape and torch.equal(g, w) for g, w in pairs):
        return "bitwise"
    worst = 0.0
    for g, w in pairs:
        if g.dtype == torch.uint8:  # a generator's state
            raise AssertionError(f"[sharded] {what}: the generators' states differ")
        if not torch.allclose(g.double(), w.double(), rtol=rtol, atol=rtol if atol is None else atol):
            raise AssertionError(f"[sharded] {what}: beyond rtol {rtol:g}")
        worst = max(worst, float((g.double() - w.double()).abs().max()))
    return f"within rtol {rtol:g} (max|d| {worst:.3e}, not bitwise)"


def observed(device, run):
    """``run()``'s result, its ms on the host's clock (device synchronised),
    the peak device memory it reached, and the K1 launches it made."""
    import torch
    from repro_torch import kernels

    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, ms = clock(device, run)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    return out, ms, peak, launches


def sharded_fleet(device, mesh, k, n):
    """Phase 6's fleet under ``SchedulerConfig(mesh=...)`` beside an
    unsharded twin from the same seed, on the same telemetry."""
    import torch
    from repro_torch import sched
    from repro_torch.device import no_sync

    total = 8 * k
    plain = sched.SchedulerConfig(min_fraction=1.0 / total)
    meshed = dataclasses.replace(plain, mesh=mesh)
    truth, gen = fleet_truth(device, k)
    uniform = torch.full((k,), 1.0 / k, device=device)
    # warm-up: the communicator is made at the first collective, which waits
    warm = sched.init(meshed, k, seed=1, device=device)
    sched.observe(warm, fleet_telemetry(truth, uniform, torch.Generator(device=device).manual_seed(5), n),
                  meshed)
    one, two = sched.init(plain, k, seed=0, device=device), sched.init(meshed, k, seed=0, device=device)
    fracs, launches, verdicts = uniform, {}, set()
    for c in range(CYCLES):
        telem = fleet_telemetry(truth, fracs, gen, n)
        (one, ll1), ms1, peak1, _ = observed(device, lambda: sched.observe(one, telem, plain))

        def sharded_observe():
            with no_sync(device):
                return sched.observe(two, telem, meshed)

        (two, ll2), ms2, peak2, got = observed(device, sharded_observe)
        for name, count in got.items():
            launches[name] = launches.get(name, 0) + count
        fr1, st1 = sched.propose(one, plain)
        with no_sync(device):
            fr2, st2 = sched.propose(two, meshed)
        q = lambda fr, st: sched.quantize_fractions(fr.cpu().numpy(), total, sched.unit_params(st),
                                                    objective=plain.objective)
        c1, c2 = q(fr1, one), q(fr2, two)
        v = agree(f"cycle {c}", (ll2, two.gibbs, two.generator, fr2, st2),
                  (ll1, one.gibbs, one.generator, fr1, st1), rtol=1e-4)
        verdicts.add(v)
        if not (c1 == c2).all():
            raise AssertionError(f"[sharded] cycle {c}: quantized counts differ at "
                                 f"{int((c1 != c2).sum())} workers")
        say(f"[sharded] fleet K={k} N={n} cycle {c}: observe sharded {ms2:.1f} ms (sync-free, peak "
            f"{peak2 / 2**20:.1f} MiB) vs unsharded {ms1:.1f} ms (peak {peak1 / 2**20:.1f} MiB); "
            f"log-likelihoods, states, generator, fractions: {v}; counts equal")
        fracs = fr2
    gap, (s_uni, s_prop, s_orc) = oracle_gap(truth, fracs, meshed)
    say(f"[sharded] fleet: E[t] under the truth uniform {s_uni:.5f}, proposed {s_prop:.5f}, oracle "
        f"{s_orc:.5f}: oracle gap recovered {100 * gap:.1f} %; K1 launches {launches}")
    return launches, gap, two


def sharded_dag(device, mesh, k, n):
    """One ``observe_dag`` of phase 11's 8-stage DAG (S K = 8 k) sharded
    against unsharded."""
    import torch
    from repro_torch import sched
    from repro_torch.device import no_sync

    _, sto = dag_topology(k)
    truth = dag_truth(k, device)
    plain = sched.SchedulerConfig(n_iters=SWEEPS, grid_size=GRID, min_fraction=1.0 / (8 * k))
    meshed = dataclasses.replace(plain, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(2017)
    f = (1.0 / k) * torch.exp(-2.0 + 4.0 * torch.rand((8, k, n), generator=gen, device=device))
    eps = torch.randn((8, k, n), generator=gen, device=device)
    t = (f ** truth.alpha[..., None] * truth.mu[..., None]
         + f ** truth.beta[..., None] * truth.sigma[..., None] * eps)
    telem = sched.Telemetry(fracs=f, times=t)
    one, two = (sched.init_dag(c, sto, seed=0, device=device) for c in (plain, meshed))
    (one, ll1), ms1, _, _ = observed(device, lambda: sched.observe_dag(one, telem, plain, dag=sto))

    def sharded():
        with no_sync(device):
            return sched.observe_dag(two, telem, meshed, dag=sto)

    (two, ll2), ms2, _, launches = observed(device, sharded)
    v = agree("observe_dag", (ll2, two.gibbs, two.generator), (ll1, one.gibbs, one.generator),
              rtol=1e-4)
    say(f"[sharded] DAG S K = 8 x {k}, N={n}: observe_dag sharded {ms2:.1f} ms (sync-free) vs "
        f"unsharded {ms1:.1f} ms; log-likelihoods, states, generator: {v}; K1 launches {launches}")
    return launches


def sharded_hier(device, mesh, state, k, n):
    """The hierarchical calls on the mesh against their unsharded forms:
    the refit, shrink and surprise on ``state`` (phase 22's sharded fleet),
    and one hierarchical ``admit_workers`` into a capacity state's dead
    slots."""
    import torch
    from repro_torch import hier, sched

    fleet = state.gibbs
    h1 = hier.fit_hyperprior(fleet)
    v_fit = agree("fit_hyperprior_sharded", hier.fit_hyperprior_sharded(fleet, mesh), h1, 1e-5, 0.0)
    v_shrink = agree("shrink", hier.shrink(fleet, h1, sharding=mesh), hier.shrink(fleet, h1), 1e-5)
    v_surprise = agree("surprise", hier.surprise(fleet, h1, sharding=mesh), hier.surprise(fleet, h1),
                       1e-5)
    plain = sched.SchedulerConfig(hierarchical=True, min_fraction=1.0 / (8 * k))
    meshed = dataclasses.replace(plain, mesh=mesh)
    truth, gen = fleet_truth(device, k)
    telem = fleet_telemetry(truth, torch.full((k,), 1.0 / k, device=device), gen, n)
    admit = k // 64  # into as many dead slots
    one, two = (sched.init(c, k - admit, seed=3, device=device, capacity=k) for c in (plain, meshed))
    one, _ = sched.observe(one, telem, plain)
    two, _ = sched.observe(two, telem, meshed)
    one, two = sched.admit_workers(one, admit, plain), sched.admit_workers(two, admit, meshed)
    v_admit = agree("hierarchical admit_workers", (two.gibbs, two.live, two.generator),
                    (one.gibbs, one.live, one.generator), rtol=1e-4)
    if int(two.live.sum()) != k:
        raise AssertionError(f"[sharded] {int(two.live.sum())} live slots after the admission, not {k}")
    say(f"[sharded] hierarchical: fit_hyperprior_sharded {v_fit}, shrink {v_shrink}, "
        f"surprise {v_surprise}; admit_workers into the {admit} dead slots of {k}: {v_admit}")


def sharded_fleet_scale(device, mesh, k):
    """One observe at phase 9 (e)'s scale (G 512, N 8, 20 sweeps) sharded
    against unsharded."""
    import torch
    from repro_torch import sched
    from repro_torch.device import no_sync

    plain = sched.SchedulerConfig(n_iters=SWEEPS, grid_size=SVC_G, mu_guess=1.25,
                                  min_fraction=1.0 / (8 * k))
    meshed = dataclasses.replace(plain, mesh=mesh)
    fracs, times = service_truth(k, device, seed=4)
    telem = sched.Telemetry(fracs=fracs[:, None].expand(k, SVC_RING).contiguous(),
                            times=torch.stack([times() for _ in range(SVC_RING)], dim=1))
    one, two = (sched.init(c, k, seed=1, device=device) for c in (plain, meshed))
    (one, ll1), ms1, peak1, _ = observed(device, lambda: sched.observe(one, telem, plain))

    def sharded():
        with no_sync(device):
            return sched.observe(two, telem, meshed)

    (two, ll2), ms2, peak2, launches = observed(device, sharded)
    v = agree(f"observe at K={k}", (ll2, two.gibbs, two.generator), (ll1, one.gibbs, one.generator),
              rtol=1e-4)
    say(f"[sharded] K={k} G={SVC_G} N={SVC_RING}, {SWEEPS} sweeps: observe sharded {ms2:.1f} ms (peak "
        f"{peak2 / 2**20:.1f} MiB, sync-free) vs unsharded {ms1:.1f} ms (peak {peak1 / 2**20:.1f} MiB); "
        f"{v}; K1 launches {launches}")
    return launches


def time_collectives(device, mesh, ks, runs=200):
    """The collectives' cost at one rank: the host ms of one
    ``gather_fleet`` of four (K,) float32 leaves (two of them a Gibbs sweep,
    as the Normal-Gamma and Beta parameters) and of the hyperprior's
    ``all_reduce`` of 13 scalars, each over ``runs`` calls with the device
    synchronised at the end."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.sharding import gather_fleet

    def per_call(fn):
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        sync(device)
        return (time.perf_counter() - t0) * 1e3 / runs

    out = {}
    for k in ks:
        leaves = tuple(torch.rand((k,), device=device) for _ in range(4))
        out[f"gather K={k}"] = per_call(lambda: gather_fleet(leaves, mesh))
    stats = torch.zeros((13,), device=device)
    out["all_reduce of 13"] = per_call(lambda: dist.all_reduce(stats, group=mesh.group))
    say(f"[sharded] collectives at one rank, host ms a call over {runs} calls: "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in out.items()))


def phase_sharded(device="cuda", k=K_FLEET, n=N_OBS, big_k=SVC_K, dag_k=DAG_K, dag_n=DAG_N):
    """Phase 22: the estimator's fleet sharding (``repro_torch.core.sharding``)
    on a one-rank world started in this process (NCCL on the card, gloo on
    the CPU), over ``ShardingConfig.auto()``: the collectives' cost, then
    phase 6's fleet, phase 11's DAG, the hierarchical calls and one observe
    at K = 100 000, each against its unsharded twin.  The world is destroyed at the end.  Returns the K1
    launches of the sharded calls by path, and the fleet's oracle gap."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.sharding import ShardingConfig

    SHARD_STORE.parent.mkdir(parents=True, exist_ok=True)
    SHARD_STORE.unlink(missing_ok=True)  # a stale store from a cut run would hang the rendezvous
    backend = "nccl" if device != "cpu" else "gloo"
    if device != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(str(SHARD_STORE), 1), rank=0, world_size=1)
    try:
        mesh = ShardingConfig.auto()
        if mesh.num_shards != 1 or mesh.mesh.device_type != torch.device(device).type:
            raise AssertionError(f"[sharded] mesh {mesh} on {device}")
        say(f"[sharded] {backend} world of 1 rank, mesh {mesh.mesh} axis {mesh.axis!r}, "
            f"{mesh.num_shards} shard")
        time_collectives(device, mesh, (k, big_k))
        fleet_launches, gap, state = sharded_fleet(device, mesh, k, n)
        dag_launches = sharded_dag(device, mesh, dag_k, dag_n)
        sharded_hier(device, mesh, state, k, n)
        del state
        scale_launches = sharded_fleet_scale(device, mesh, big_k)
    finally:
        dist.destroy_process_group()
        SHARD_STORE.unlink(missing_ok=True)
    return dict(sharded=fleet_launches, sharded_dag=dag_launches,
                sharded_fleet_scale=scale_launches), gap


# Phase 23: model-tensor sharding (``repro_torch.distributed.sharding`` and
# the model stack's mesh hooks) on a one-rank NCCL world and a (1, 1)
# ("data", "model") mesh.  One card hides every collective (the 4-rank gloo
# tests prove them); here the mesh path runs at full width with its kernels
# under local_map, and its DTensor dispatch is timed beside the unsharded twin.
MESH_SERVE = (4, 1024, 8)  # batch, prompt, decode steps; recurrentgemma-2b, all 26 layers
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS, MESH_TRAIN_MB = 6, 2, 4
MESH_TRAIN_SHAPE = dict(seq_len=512, global_batch=8)
# int8_ef (TRAIN_RUN's): each replicated gradient compressed whole (fault 3g)
MESH_TRAIN_RUN = dict(TRAIN_RUN, partitioner_refit_every=2, warmup_steps=1)
MESH_MOE_TOKENS = (4, 512)  # granite-moe-3b-a800m's MoE layer at full width
MESH_STORE = ROOT / "build" / "model_sharding_store"  # git-ignored; the world's FileStore
MESH_DIR = ROOT / "build" / "model_sharding_ckpt"  # git-ignored; never written (no checkpoint)
MESH_TOL = dict(rtol=1e-5, atol=0.0)  # the trainers' losses on one rank
MOE_MESH_ATOL = 2e-2  # the MoE layer's bfloat16 output: a few units of its last place


def whole(x):
    """A DTensor gathered whole; any other tensor as it is."""
    from repro_torch.device import is_dtensor

    return x.full_tensor() if is_dtensor(x) else x


def mesh_serve(device, mi, cfg, batch, prompt, steps):
    """Prefill and ``steps`` decode steps of full-width ``cfg`` twice, the
    unsharded twin and on the mesh (parameters placed by
    ``tree_shardings(default_rules(fsdp=False))``, the cache by
    ``cache_shardings``), each run once to warm up and once timed.  Returns
    ((twin logits, mesh logits), (prefill ms, decode ms a token) of each,
    the mesh run's launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx

    params = model_zoo.init_model_params(cfg, seed=0, device=device)
    specs = shd.tree_shardings(model_zoo.abstract_model_params(cfg), model_zoo.model_axes(cfg),
                               mi.mesh, shd.default_rules(mi.mesh, fsdp=False))
    placed = shd.shard_tree(params, specs, mi.mesh)
    gen = torch.Generator(device=device).manual_seed(23)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt + steps), generator=gen,
                           device=device, dtype=torch.int32)

    def run(p, info):
        cache = model_zoo.init_cache(cfg, batch, prompt + steps + 8, device=device)
        if info is not None:
            cache = shd.shard_tree(cache, shd.cache_shardings(
                cache, model_zoo.transformer.cache_axes_tree(cfg), info.mesh), info.mesh)
        (logits, cache), pre_ms = clock(device, lambda: model_zoo.prefill(
            cfg, p, {"tokens": tokens[:, :prompt]}, cache, ctx=ApplyCtx(mode="prefill",
                                                                        mesh_info=info)))
        outs, ms = [whole(logits)], []
        for j in range(prompt, prompt + steps):
            (logits, cache), t = clock(device, lambda: model_zoo.decode_step(
                cfg, p, tokens[:, j:j + 1], cache, ctx=ApplyCtx(mode="decode", mesh_info=info)))
            outs.append(whole(logits))
            ms.append(t)
        return torch.stack(outs), (pre_ms, statistics.median(ms))

    got, times, launches = {}, {}, {}
    for tag, p, info in (("twin", params, None), ("mesh", placed, mi)) * 2:  # warm-up, timed
        kernels.reset_launch_counts()
        got[tag], times[tag] = run(p, info)
        launches[tag] = kernels.launch_counts()
    return (got["twin"], got["mesh"]), times, launches["mesh"]


def mesh_train(device, mi, cfg, steps, m, shape):
    """``Trainer`` on ``cfg`` with the partitioner on a simulated fleet, the
    unsharded twin and then ``Trainer(mesh_info=mi)`` from the same seed, each
    ``steps`` steps (one drain), the first step a warm-up and the rest timed
    on the host's clock.  Returns (twin losses, mesh losses, (twin ms, mesh
    ms) a timed step, the mesh trainer's launches)."""
    import shutil

    import torch
    from repro_torch import kernels
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.device import is_dtensor
    from repro_torch.distributed.simulated_cluster import SimulatedCluster
    from repro_torch.launch.train import simulated_fleet
    from repro_torch.train.trainer import Trainer

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    run = RunConfig(model=cfg, shape=ShapeConfig("phase23", kind="train", **shape),
                    total_steps=steps, checkpoint_every=10**9, checkpoint_dir=str(MESH_DIR),
                    **MESH_TRAIN_RUN)
    out = {}
    for tag, info in (("twin", None), ("mesh", mi)):
        kernels.reset_launch_counts()
        trainer = Trainer(run, cluster=SimulatedCluster(simulated_fleet(TRAIN_WORKERS)),
                          num_microbatches=m, mesh_info=info, device=device)
        if info is not None and not is_dtensor(trainer.params["embed"]):
            raise AssertionError("[mesh-train] the trainer's parameters are not DTensors")
        first = trainer.train(1).losses
        report, ms = clock(device, lambda: trainer.train(steps - 1))
        out[tag] = (first + report.losses, ms / (steps - 1), kernels.launch_counts())
        del trainer
        if device != "cpu":
            torch.cuda.empty_cache()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return out["twin"][0], out["mesh"][0], (out["twin"][1], out["mesh"][1]), out["mesh"][2]


def mesh_moe(device, mi, cfg, tokens):
    """One MoE layer of full-width ``cfg`` on the mesh (on one rank: the
    tensor-parallel path, d_ff over a model axis of 1) against the same
    layer unsharded.  Returns (the path, max |err|, bitwise)."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe, params as mp
    from repro_torch.models.layers import ApplyCtx, constrain_batch, mesh_scope

    spec = moe.moe_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(5)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    layer = mp.init_params(spec, gen, dtype, device)
    x = torch.randn((*tokens, cfg.d_model), generator=gen, device=device).to(dtype)
    want, _ = moe.moe_ffn(cfg, layer, x)
    specs = shd.tree_shardings(mp.abstract_params(spec), mp.axes_tree(spec), mi.mesh,
                               shd.default_rules(mi.mesh, fsdp=False))
    ctx = ApplyCtx(mode="train", mesh_info=mi)
    with torch.no_grad(), mesh_scope(ctx):
        got, _ = moe.moe_ffn(cfg, shd.shard_tree(layer, specs, mi.mesh), constrain_batch(x, ctx), ctx)
    got = whole(got)
    err = float((got.float() - want.float()).abs().max())
    return moe.moe_path(cfg, mi), err, bool(torch.equal(got, want))


def k2_lse_checks():
    """K2's log-sum-exp output on the card: against the plain version at
    phase 7's shape and at every compiled (G, D) (lengths 0, one chunk's
    tail, all S); a float32 cache at phase 7's shape split in two halves,
    each with its own valid count, merged by the log-sum-exps against K2 on
    the whole (a row whose second half is empty: that half's lse -inf, its
    output zeros, the merge bitwise the first half's).  Returns the worst
    |err| of the outputs and of the log-sum-exps, and K2's time at phase 7's
    shape with and without the output."""
    import torch
    from repro_torch.kernels.decode_attention import (
        INSTANTIATED,
        decode_attention,
        decode_attention_plain,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    err_out = err_lse = 0.0
    cases = [(K2_PATH, bf16, f32, None)] + [((3, g * 2, 2, d, 200), f32, f32, [0, 70, 200])
                                            for g, d in sorted(INSTANTIATED)]
    for i, (shape, q_dt, kv_dt, length) in enumerate(cases):
        q, k, v, n = decode_case(*shape, seed=230 + i, q_dtype=q_dt, kv_dtype=kv_dt, length=length)
        out, lse = decode_attention(q, k, v, n, return_lse=True)
        want_out, want_lse = decode_attention_plain(q, k, v, n, return_lse=True)
        if not torch.equal(out, decode_attention(q, k, v, n)):
            raise AssertionError(f"[k2-lse] {shape}: the output changed with the flag")
        live = n > 0
        if not bool(torch.isneginf(lse[~live]).all()):
            raise AssertionError(f"[k2-lse] {shape}: an empty row set's lse is not -inf")
        err_lse = max(err_lse, assert_close(lse[live].cpu(), want_lse[live].cpu(), rtol=RTOL,
                                            atol=RTOL))
        err_out = max(err_out, assert_close(out.float().cpu(), want_out.float().cpu(),
                                            rtol=RTOL if q_dt == f32 else 2e-2,
                                            atol=RTOL if q_dt == f32 else 2e-2))
    b, h, kvh, d, s = K2_PATH
    half = s // 2
    q, k, v, _ = decode_case(*K2_PATH, seed=239, q_dtype=f32, kv_dtype=f32)
    n = torch.tensor([s, 1500, half, 700], dtype=torch.int32, device="cuda")[:b]
    whole_out = decode_attention(q, k, v, n)
    parts = [decode_attention(q, k[:, r * half:(r + 1) * half].contiguous(),
                              v[:, r * half:(r + 1) * half].contiguous(),
                              torch.clamp(n - r * half, 0, half), return_lse=True)
             for r in range(2)]
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - lse.max(dim=0).values)[..., None]
    merged = (w[0] * parts[0][0] + w[1] * parts[1][0]) / w.sum(dim=0)
    err_out = max(err_out, assert_close(merged.cpu(), whole_out.cpu(), rtol=RTOL, atol=RTOL))
    empty = n <= half
    if not (bool(torch.isneginf(parts[1][1][empty]).all()) and not bool(parts[1][0][empty].any())
            and torch.equal(merged[empty], parts[0][0][empty])):
        raise AssertionError("[k2-lse] an empty half added something to the merge")
    sets = [decode_case(*K2_PATH, seed=7 + i, q_dtype=bf16, kv_dtype=f32, length=[s] * b)
            for i in range(8)]
    with_lse = lambda q, k, v, n: decode_attention(q, k, v, n, return_lse=True)
    ms, lse_ms = (time_cuda(round_robin(fn, sets), runs=30, reps=20)
                  for fn in (decode_attention, with_lse))
    say(f"[k2-lse] log-sum-exp output against the plain version at {len(cases)} shapes (phase 7's "
        f"and every compiled (G, D)): max|err| {err_lse:.3e}, outputs {err_out:.3e}; phase 7's "
        f"float32 cache split in two halves of {half} rows (lengths {n.tolist()}) and merged by "
        f"log-sum-exp equals K2 on the whole; an empty half adds nothing")
    say(f"[k2-lse] K2 at {K2_PATH}: {ms:.4f} ms without the output, {lse_ms:.4f} ms with it")
    return err_out, err_lse, dict(ms=ms, with_lse_ms=lse_ms)


def phase_model_sharded(device="cuda", serve_cfg=None, serve=MESH_SERVE, train_cfg=None,
                        train_steps=MESH_TRAIN_STEPS, train_mb=MESH_TRAIN_MB,
                        train_shape=MESH_TRAIN_SHAPE, moe_cfg=None, moe_tokens=MESH_MOE_TOKENS):
    """Phase 23: the model stack on a (1, 1) ("data", "model") mesh over a
    one-rank world started in this process (NCCL on the card, gloo on the
    CPU), destroyed at the end: full-width recurrentgemma-2b served (prefill
    and decode through K3 and K2 under local_map) against its unsharded twin;
    ``Trainer(mesh_info=)`` on it cut to MESH_TRAIN_LAYERS layers against the
    unsharded trainer; one full-width granite MoE layer on the mesh against
    the unsharded layer.  Returns the mesh runs' launches by path."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.models import MeshInfo

    serve_cfg = serve_cfg or get_arch(SERVE_ARCH)
    train_cfg = train_cfg or dataclasses.replace(get_arch(HYBRID_ARCH), num_layers=MESH_TRAIN_LAYERS)
    moe_cfg = moe_cfg or get_arch(GRANITE_ARCH)
    MESH_STORE.parent.mkdir(parents=True, exist_ok=True)
    MESH_STORE.unlink(missing_ok=True)  # a stale store from a cut run would hang the rendezvous
    backend = "nccl" if device != "cpu" else "gloo"
    if device != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(str(MESH_STORE), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh(torch.device(device).type, (1, 1), mesh_dim_names=("data", "model"))
        mi = MeshInfo(mesh, ("data",), "model")
        say(f"[mesh] {backend} world of 1 rank, {mesh}")
        (twin, got), times, serve_launches = mesh_serve(device, mi, serve_cfg, *serve)
        if got.shape != (serve[2] + 1, serve[0], serve_cfg.vocab_size) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"[mesh-serve] logits {tuple(got.shape)} not finite or misshapen")
        bitwise = bool(torch.equal(got, twin))
        err = assert_close(got.float().cpu(), twin.float().cpu(), **TF_TOL)
        say(f"[mesh-serve] {serve_cfg.name} ({serve_cfg.num_layers} layers) batch {serve[0]} prompt "
            f"{serve[1]}, {serve[2]} decode steps on the mesh: logits "
            f"{'bitwise' if bitwise else f'max|err| {err:.3e} (TF_TOL)'} the unsharded twin's; "
            f"prefill {times['mesh'][0]:.1f} ms (twin {times['twin'][0]:.1f}), decode "
            f"{times['mesh'][1]:.2f} ms/token (twin {times['twin'][1]:.2f}); launches {serve_launches}")
        del twin, got
        twin_losses, losses, step_ms, train_launches = mesh_train(
            device, mi, train_cfg, train_steps, train_mb, train_shape)
        import numpy as np

        np.testing.assert_allclose(losses, twin_losses, **MESH_TOL)
        say(f"[mesh-train] {train_cfg.name} cut to {train_cfg.num_layers} layers, "
            f"{train_shape['global_batch']} x {train_shape['seq_len']} in {train_mb} microbatches, "
            f"{train_steps} steps: losses {losses} on the mesh, {twin_losses} unsharded (rtol "
            f"{MESH_TOL['rtol']}); {step_ms[1]:.1f} ms a step after the first (unsharded "
            f"{step_ms[0]:.1f}); "
            f"launches {train_launches}")
        path, moe_err, moe_bitwise = mesh_moe(device, mi, moe_cfg, moe_tokens)
        if moe_err > MOE_MESH_ATOL:
            raise AssertionError(f"[mesh-moe] max|err| {moe_err:.3e} against the unsharded layer")
        say(f"[mesh-moe] {moe_cfg.name} MoE layer, {moe_tokens[0]} x {moe_tokens[1]} tokens, on the "
            f"mesh ({path} path): {'bitwise' if moe_bitwise else f'max|err| {moe_err:.3e}'} the "
            f"unsharded layer")
    finally:
        dist.destroy_process_group()
        MESH_STORE.unlink(missing_ok=True)
    return dict(model_sharded_serve=serve_launches, model_sharded_train=train_launches)


# Phase 24: the dry run (``repro_torch.launch.dryrun``): the reference test's
# cell on the 16 x 16 mesh of a fake world of 512 ranks, on both device
# routes; then its estimate of a cut step against the card's own peak.
DRYRUN_CELL = ("tinyllama-1.1b", "decode_32k", "single")
DRYRUN_CHECK_BATCH = 8  # decode_32k cut from 128 sequences to 8 for the (1, 1) check
DRYRUN_PEAK_TOL = 0.10  # the measured peak against the estimate, relative to the estimate
DRYRUN_DIR = ROOT / "build" / "dryrun"  # git-ignored; the cells' JSON files
DRYRUN_STORE = ROOT / "build" / "dryrun_store"  # git-ignored; the check's one-rank world
DRYRUN_KEYS = ("memory", "full_cost", "full_coll", "kernel_calls")  # what both routes must agree on


def start_src(argv):
    """``argv`` started in a subprocess with ``src`` on the path."""
    import os

    return subprocess.Popen(argv, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait_src(proc, what, timeout=900):
    """The standard output of a subprocess from ``start_src``, which must exit 0."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"[{what}] exit {proc.returncode}: {out[-2000:]}{err[-3000:]}")
    return out


def start_dryrun_cell(device):
    """``python -m repro_torch.launch.dryrun`` on DRYRUN_CELL with ``--device``,
    started."""
    arch, shape, mesh = DRYRUN_CELL
    return start_src([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                      "--shape", shape, "--mesh", mesh, "--device", device,
                      "--out", str(DRYRUN_DIR / device), "--force"])


def dryrun_cell(device, proc, t0):
    """The cell's JSON of a ``start_dryrun_cell`` subprocess, printed."""
    arch, shape, mesh = DRYRUN_CELL
    wait_src(proc, f"dryrun-{device}")
    cell = json.loads((DRYRUN_DIR / device / f"{arch}__{shape}__{mesh}.json").read_text())
    full = cell["full"]
    say(f"[dryrun] {cell['cell']} --device {device}: {cell['chips']} chips {cell['mesh']}; per "
        f"device flops {full['full_cost']['flops']:.6e}, bytes {full['full_cost']['bytes']:.6e}, "
        f"collective bytes {full['full_coll']}, peak {full['memory']['peak_bytes_est']:.6e} "
        f"(arguments {full['memory']['argument_bytes']:.6e}), kernel calls "
        f"{full['kernel_calls']}; the step {full['step_seconds']} s, done {time.time() - t0:.1f} s "
        f"after the phase's start")
    roof = cell["roofline"]
    say(f"[dryrun] {cell['cell']} --device {device} roofline (the H100 model's seconds, not a "
        f"measured time): terms {roof['terms_seconds']}, dominant {roof['dominant']}, bound "
        f"{roof['roofline_bound_s']:.6e} s; collective bytes by axis "
        f"{roof['per_device']['collective_by_axis']}; units "
        f"{[(u['name'], u['trips']) for u in roof['units']]}")
    return cell


# The train step's units (the optimizer's among them) of full-width smollm-135m
# cut to 2 layers, 8 x 64 tokens in 4 microbatches on a (2, 2) mesh of the
# fake world, on the route argv[1] names: what both routes must count alike
TRAIN_UNITS_CODE = """
import dataclasses, json, sys, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import RunConfig, ShapeConfig, get_arch
from repro_torch.launch import dryrun
dryrun.fake_world()
cfg = dataclasses.replace(get_arch("smollm-135m"), num_layers=2)
shape = ShapeConfig("cut", seq_len=64, global_batch=8, kind="train")
mesh = DeviceMesh(sys.argv[1], torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
run = RunConfig(model=cfg, shape=shape, optimizer_dtype="float32", remat="full")
units = dryrun.train_units(cfg, run, shape, mesh, 4)
print(json.dumps([dataclasses.asdict(u) for u in units]))
"""

ESTIMATE_CODE = """
import json, sys, dataclasses
from repro_torch.configs import get_arch, get_shape, reduced
from repro_torch.launch import dryrun
arch, shape, batch, small, device = json.loads(sys.argv[1])
cfg = reduced(get_arch(arch)) if small else get_arch(arch)
shape = dataclasses.replace(get_shape(shape), global_batch=batch)
print(json.dumps(dryrun.cut_cell(cfg, shape, (1, 1), device=device)))
"""


def phase_dryrun(device="cuda", small=False):
    """Phase 24: the dry run of DRYRUN_CELL on both routes (``--device cuda``
    and ``cpu``: the same counts and the same unit roofline, exactly; the
    reference test's conditions on the roofline, memory-bound under 50 ms;
    the vocab-split lookup's all-gather under 1 MB), its tables by
    ``python -m repro_torch.launch.report``, and a cut train step's units
    on both routes (every count of every unit equal); then
    ``dryrun.cut_cell`` of its
    decode step cut to DRYRUN_CHECK_BATCH sequences on a (1, 1) mesh, and
    the same step run for real on a (1, 1) mesh over a one-rank world (NCCL
    on the card), its peak (``max_memory_allocated`` above what was
    allocated before its arguments) within DRYRUN_PEAK_TOL of the
    estimate's, and its K2 launches one an attention layer, as the
    estimate's calls.  ``small`` runs the check at the reduced config (a
    rehearsal on the CPU, where no peak is measured).  Returns the real
    step's launches."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import kernels
    from repro_torch.configs import get_arch, get_shape, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import MeshInfo, model_zoo
    from repro_torch.models.layers import ApplyCtx
    from repro_torch.train import serve_step

    arch, shape_name, _ = DRYRUN_CELL
    cfg = reduced(get_arch(arch)) if small else get_arch(arch)
    shape = dataclasses.replace(get_shape(shape_name), global_batch=DRYRUN_CHECK_BATCH)
    t0 = time.time()  # the two routes and the estimate run at once, each a process
    devices = ("cuda", "cpu") if device != "cpu" else ("cpu",)
    procs = {d: start_dryrun_cell(d) for d in devices}
    units = {d: start_src([sys.executable, "-c", TRAIN_UNITS_CODE, d]) for d in devices}
    estimate = start_src([sys.executable, "-c", ESTIMATE_CODE, json.dumps(
        [arch, shape_name, DRYRUN_CHECK_BATCH, small, device])])
    routes = {d: dryrun_cell(d, proc, t0) for d, proc in procs.items()}
    units = {d: json.loads(wait_src(proc, f"dryrun-units-{d}").splitlines()[-1])
             for d, proc in units.items()}
    first_units = next(iter(units.values()))
    for d, us in units.items():
        say(f"[dryrun-units] smollm-135m cut to 2 layers, train 8 x 64 on (2, 2), --device {d}: "
            + "; ".join(f"{u['name']} x{u['trips']} flops {u['flops']:.6e} bytes {u['bytes']:.6e} "
                        f"collectives {u['coll']} by axis {u['coll_by_axis']}" for u in us))
        if us != first_units or us[-1]["name"] != "optimizer":
            raise AssertionError(f"[dryrun-units] --device {d}'s train units differ")
    first = next(iter(routes.values()))
    for d, cell in routes.items():
        diff = [k for k in DRYRUN_KEYS if cell["full"][k] != first["full"][k]]
        if diff:
            raise AssertionError(f"[dryrun] --device {d} differs from the other route in {diff}")
        if cell["roofline"] != first["roofline"]:
            raise AssertionError(f"[dryrun] --device {d}'s roofline differs from the other route's")
    full, roof = first["full"], first["roofline"]
    if first["chips"] != 256 or first["mesh"] != {"data": 16, "model": 16} or \
            not (full["full_cost"]["flops"] > 0 and full["memory"]["peak_bytes_est"] > 0):
        raise AssertionError(f"[dryrun] cell {first}")
    # the reference test's conditions, and the vocab-split lookup's (fault 3j)
    if roof["dominant"] != "memory_s" or not roof["roofline_bound_s"] < 0.05 or \
            not roof["per_device"]["flops"] > 0:
        raise AssertionError(f"[dryrun] roofline {roof['terms_seconds']}, {roof['dominant']}")
    if not full["full_coll"]["all-gather"] < 1_000_000:
        raise AssertionError(f"[dryrun] all-gather {full['full_coll']['all-gather']} B, not < 1 MB")
    say(f"[dryrun] both routes agree exactly on {', '.join(DRYRUN_KEYS)} and the roofline; "
        f"memory-bound, bound {1e3 * roof['roofline_bound_s']:.4f} ms < 50 ms; all-gather "
        f"{full['full_coll']['all-gather']} B < 1 MB")
    route = "cuda" if device != "cpu" else "cpu"
    tables = wait_src(start_src([sys.executable, "-m", "repro_torch.launch.report", "--dir",
                                 str(DRYRUN_DIR / route)]), "dryrun-report")
    for line in tables.strip().splitlines():
        say(f"[dryrun-report] {line}")

    est = json.loads(wait_src(estimate, "dryrun-estimate").splitlines()[-1])
    want_calls = {"decode_attention": attention_layers(cfg)}
    if est["kernel_calls"] != want_calls:
        raise AssertionError(f"[dryrun-check] estimated kernel calls {est['kernel_calls']}, not "
                             f"{want_calls}")

    DRYRUN_STORE.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_STORE.unlink(missing_ok=True)
    if device != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if device != "cpu" else "gloo",
                            store=dist.FileStore(str(DRYRUN_STORE), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh(torch.device(device).type, (1, 1), mesh_dim_names=("data", "model"))
        mi = MeshInfo(mesh, ("data",), "model")
        on_card = device != "cpu"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
        params = model_zoo.init_model_params(cfg, seed=0, device=device)
        specs = shd.tree_shardings(model_zoo.abstract_model_params(cfg), model_zoo.model_axes(cfg),
                                   mesh, shd.default_rules(mesh, fsdp=False))
        params = shd.shard_tree(params, specs, mesh)
        cache = model_zoo.init_cache(cfg, shape.global_batch, shape.seq_len, device=device)
        cache = shd.shard_tree(cache, shd.cache_shardings(
            cache, model_zoo.transformer.cache_axes_tree(cfg), mesh), mesh)
        cache["length"].fill_(shape.seq_len - 1)  # the step reads every row, as the cell's
        gen = torch.Generator(device=device).manual_seed(24)
        token = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1), generator=gen,
                              device=device, dtype=torch.int32)
        step = serve_step.make_decode_step(cfg, ctx=ApplyCtx(mode="decode", mesh_info=mi))
        if on_card:
            torch.cuda.synchronize()
            args_bytes = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out, _ = step(params, token, cache)
        if on_card:
            torch.cuda.synchronize()
        launches = kernels.launch_counts()
        out = whole(out)
        if out.shape != (shape.global_batch, 1) or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            raise AssertionError(f"[dryrun-check] tokens {tuple(out.shape)} out of range")
        if on_card:
            peak = torch.cuda.max_memory_allocated() - base
            want = est["memory"]["peak_bytes_est"]
            miss = (peak - want) / want
            say(f"[dryrun-check] {cfg.name} decode_32k cut to {shape.global_batch} sequences on a "
                f"(1, 1) mesh: estimated peak {want:.6e} B (arguments "
                f"{est['memory']['argument_bytes']:.6e}, temporaries "
                f"{est['memory']['temp_bytes']:.6e}), measured on the card {peak:.6e} B "
                f"(arguments {args_bytes:.6e}), {100 * miss:+.2f} %; estimated kernel calls "
                f"{est['kernel_calls']}, launches {launches}")
            if abs(miss) > DRYRUN_PEAK_TOL:
                raise AssertionError(f"[dryrun-check] measured peak {peak} is {100 * miss:+.2f} % "
                                     f"off the estimate {want}")
        else:
            say(f"[dryrun-check] {cfg.name} decode_32k cut to {shape.global_batch} sequences on a "
                f"(1, 1) mesh: estimated peak {est['memory']['peak_bytes_est']:.6e} B, kernel "
                f"calls {est['kernel_calls']}; the step ran (no peak is measured off the card)")
        del params, cache, out
    finally:
        dist.destroy_process_group()
        DRYRUN_STORE.unlink(missing_ok=True)
    return launches


def main() -> int:
    card = phase_environment()
    phase_build()
    import serve_partitioned_torch as example
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import build as kbuild
    from repro_torch.models.transformer import layer_kinds

    errs = dict(posterior_grid_fleet=phase_k1_parity(), decode_attention=phase_k2_parity(),
                lru_scan=phase_k3_parity(), lru_scan_bwd=phase_k3_backward_parity())
    timing = dict(posterior_grid_fleet=phase_k1_timing(), decode_attention=phase_k2_timing(),
                  lru_scan=phase_k3_timing(), lru_scan_bwd=phase_k3_backward_timing())
    phase_quickstart()
    fleet_launches, gap = phase_fleet()
    expected = CYCLES * SWEEPS
    if fleet_launches.get("posterior_grid_fleet") != expected:
        raise AssertionError(f"K1 launched {fleet_launches} times on the fleet path, not {expected}")
    if gap < 0.8:
        raise AssertionError(f"oracle gap recovered {100 * gap:.1f} % < 80 %")
    serve_launches = phase_serve()
    kinds = layer_kinds(get_arch(SERVE_ARCH))
    want = dict(lru_scan=kinds.count("rglru"),  # once per RG-LRU layer of the prefill
                lru_scan_bwd=0,  # serving runs no backward
                decode_attention=kinds.count("localattn") * (SERVE_GEN - 1))  # per decode step
    for name, n in want.items():
        if serve_launches.get(name) != n:
            raise AssertionError(f"{name} launched {serve_launches.get(name)} times in serving, not {n}")
    phase_teacher_forcing()
    smollm_launches = phase_serve_smollm()
    granite_launches, granite_ffn = phase_serve_granite()
    check_moe_layer_parity(granite_ffn)
    del granite_ffn
    phase_teacher_forcing_granite()
    arctic_launches = phase_serve_arctic()
    whisper_launches = phase_serve_whisper()
    internvl_launches = phase_serve_family("internvl2", INTERNVL, INTERNVL_ARGV)
    yi_launches = phase_serve_family("yi", YI, YI_ARGV)
    command_r_launches = phase_serve_command_r()
    xlstm_launches = phase_serve_xlstm()
    tinyllama_launches = phase_serve_family("tinyllama", TINYLLAMA, TINYLLAMA_ARGV)
    tiny_cfg = get_arch(TINYLLAMA[0])
    want = attention_layers(tiny_cfg) * (TINYLLAMA[3] - 1)  # 22 x 15 = 330 at (8, 64)
    if tinyllama_launches != dict(posterior_grid_fleet=0, decode_attention=want, lru_scan=0,
                                  lru_scan_bwd=0):
        raise AssertionError(f"[tinyllama] launches {tinyllama_launches}, not {want} of K2")
    phase_teacher_forcing_families()
    phase_teacher_forcing_xlstm()
    service_launches, service_runs = phase_service()
    drives = 2 * (1 + SVC_TICKS)  # dense and active loops, a warm-up tick and the timed ones
    if service_launches.get("posterior_grid_fleet") != SWEEPS * drives:
        raise AssertionError(f"K1 launched {service_launches} times on the service path, "
                             f"not {SWEEPS * drives}")
    ckpt_launches = phase_checkpoint(service_runs["dense"].pop("loop"))
    del service_runs
    # 20 sweeps a tick of two loops, CKPT_TICKS each, then two observes
    if ckpt_launches != dict(posterior_grid_fleet=SWEEPS * (2 * CKPT_TICKS + 2), decode_attention=0,
                             lru_scan=0, lru_scan_bwd=0):
        raise AssertionError(f"[checkpoint] launches {ckpt_launches}, not "
                             f"{SWEEPS * (2 * CKPT_TICKS + 2)} of K1")
    part_launches, part_errs = phase_partitioned("partitioned", PART_ARGV, smoke=True)
    vlm_launches, vlm_errs = phase_partitioned("partitioned-vlm", PART_VLM_ARGV)
    for name in errs:
        errs[name] = max(errs[name], part_errs.get(name, 0.0), vlm_errs.get(name, 0.0))
    dag_launches, dag_err = phase_dag()
    errs["posterior_grid_fleet"] = max(errs["posterior_grid_fleet"], dag_err)
    if dag_launches.get("posterior_grid_fleet") != SWEEPS * CYCLES:  # 20 per observe_dag
        raise AssertionError(f"K1 launched {dag_launches} times on the DAG path, not {SWEEPS * CYCLES}")
    example_launches, example_out, example_cfg = phase_example()
    served = sum(int(r["counts"][0]) > 0 for r in example_out["rounds"])  # rounds replica 0 served
    want = dict(posterior_grid_fleet=example_out["config"].sched.n_iters
                * example_out["counters"]["drains"],
                decode_attention=attention_layers(example_cfg) * example.DECODE_STEPS * served,
                lru_scan=0, lru_scan_bwd=0)
    if example_launches != want:
        raise AssertionError(f"[example] launches {example_launches}, not {want}")
    example_errs = phase_example_parity(example_out, example_cfg)
    del example_out
    for name, err in example_errs.items():
        errs[name] = max(errs[name], err)
    legacy_ctx, legacy_launches, legacy_gap = phase_legacy()
    want = dict(posterior_grid_fleet=2 * CYCLES * SWEEPS, decode_attention=0, lru_scan=0,
                lru_scan_bwd=0)
    if legacy_launches != want:  # 20 sweeps an observe, 3 cycles, 2 partitioners
        raise AssertionError(f"[legacy] launches {legacy_launches}, not {want}")
    if legacy_gap < 0.8:
        raise AssertionError(f"[legacy] oracle gap recovered {100 * legacy_gap:.1f} % < 80 %")
    fault_launches = phase_fault_tolerance(legacy_ctx)
    del legacy_ctx
    if fault_launches != dict(posterior_grid_fleet=SWEEPS, decode_attention=0, lru_scan=0,
                              lru_scan_bwd=0):
        raise AssertionError(f"[fault] launches {fault_launches}, not {SWEEPS} of K1")
    phase_compression()
    kbuild.reset_launch_counts()
    phase_train_parity()
    parity_launches = kbuild.launch_counts()
    # reduced recurrentgemma: its RG-LRU layers x 4 microbatches x 3 steps, K3
    # twice (the forward and remat's recompute) and its backward once
    n = layer_kinds(reduced(get_arch(HYBRID_ARCH))).count("rglru") * 4 * 3
    want = dict(posterior_grid_fleet=0, decode_attention=0, lru_scan=2 * n, lru_scan_bwd=n)
    if parity_launches != want:
        raise AssertionError(f"[train-parity] launches {parity_launches}, not {want}")
    say(f"[train-parity] launches: {parity_launches}")
    train_launches, train_k1, train_remat = phase_train()
    drains = TRAIN_STEPS // TRAIN_RUN["partitioner_refit_every"]
    if train_launches != dict(posterior_grid_fleet=SWEEPS * drains, decode_attention=0, lru_scan=0,
                              lru_scan_bwd=0):
        raise AssertionError(f"[train] launches {train_launches}, not {SWEEPS} x {drains} of K1")
    none = dict(posterior_grid_fleet=0, decode_attention=0, lru_scan=0, lru_scan_bwd=0)
    if any(c != none for c in train_remat.values()):
        raise AssertionError(f"[train] a dense microbatch launched a kernel: {train_remat}")
    cli_launches = phase_train_cli()
    if cli_launches != dict(posterior_grid_fleet=SWEEPS, decode_attention=0, lru_scan=0,
                            lru_scan_bwd=0):
        raise AssertionError(f"[train-cli] launches {cli_launches}, not {SWEEPS} of K1 (one drain)")
    errs["posterior_grid_fleet"] = max(errs["posterior_grid_fleet"], phase_train_k1_parity(train_k1))
    hybrid_launches, hybrid_k1, hybrid_cfg, hybrid_remat = phase_train_hybrid()
    # a step: the cut's RG-LRU layers x 8 microbatches, K3 twice (the forward
    # and remat's recompute), its backward once; K1 20 a drain
    n = layer_kinds(hybrid_cfg).count("rglru") * TRAIN_MB * HYBRID_STEPS
    want = dict(posterior_grid_fleet=SWEEPS * HYBRID_STEPS // HYBRID_RUN["partitioner_refit_every"],
                decode_attention=0, lru_scan=2 * n, lru_scan_bwd=n)
    if hybrid_launches != want:
        raise AssertionError(f"[train-hybrid] launches {hybrid_launches}, not {want}")
    errs["posterior_grid_fleet"] = max(errs["posterior_grid_fleet"], phase_train_k1_parity(hybrid_k1))
    # one microbatch: K3 once an RG-LRU layer without remat; under "full",
    # "dots" and "outs" twice (the policy recomputes K3's custom op), its
    # backward once
    n = layer_kinds(hybrid_cfg).count("rglru")
    for remat, got in hybrid_remat.items():
        want = dict(posterior_grid_fleet=0, decode_attention=0, lru_scan=(1 if remat == "none" else 2) * n,
                    lru_scan_bwd=n)
        if got != want:
            raise AssertionError(f"[train-hybrid] remat {remat}: launches {got}, not {want}")
    say(f"[train-hybrid] one microbatch's launches by remat: {hybrid_remat}")
    hetero_launches, hetero_drains, hetero_k1 = phase_train_hetero()
    if hetero_launches != dict(none, posterior_grid_fleet=SWEEPS * hetero_drains):
        raise AssertionError(f"[hetero] launches {hetero_launches}, not {SWEEPS} x {hetero_drains} of K1")
    import elastic_failover_torch as elastic

    elastic_launches, elastic_out, _, elastic_k1 = phase_elastic()
    # 20 an observe at the trainers' drains (every 8 steps; each phase starts
    # at a multiple of 8), 3 in phase 5: the fleet's 6 rounds, then one a
    # cycle of 4 observations for each newcomer
    obs = elastic_out["obs"]
    want = SWEEPS * sum(n // 8 for n in elastic.PHASE_STEPS) + elastic.CFG5.n_iters * (
        6 + (obs["pooled"] + obs["global"]) // 4)
    if elastic_launches != dict(none, posterior_grid_fleet=want):
        raise AssertionError(f"[elastic] launches {elastic_launches}, not {want} of K1")
    del elastic_out
    # K1 against its plain version at every shape the two examples gave it:
    # the trainers' (K, G, ring capacity), 4 workers in train_hetero and 3
    # then 2 in elastic's phases 1-4, and phase 5's fleet and newcomers
    for shape in sorted(hetero_k1 | elastic_k1):
        errs["posterior_grid_fleet"] = max(errs["posterior_grid_fleet"], phase_train_k1_parity(shape))
    sharded_launches, sharded_gap = phase_sharded()
    want = dict(sharded=dict(none, posterior_grid_fleet=CYCLES * SWEEPS),  # 20 an observe
                sharded_dag=dict(none, posterior_grid_fleet=SWEEPS),
                sharded_fleet_scale=dict(none, posterior_grid_fleet=SWEEPS))
    if sharded_launches != want:
        raise AssertionError(f"[sharded] launches {sharded_launches}, not {want}")
    if sharded_gap < 0.8:
        raise AssertionError(f"[sharded] oracle gap recovered {100 * sharded_gap:.1f} % < 80 %")
    model_launches = phase_model_sharded()
    cut = dataclasses.replace(get_arch(HYBRID_ARCH), num_layers=MESH_TRAIN_LAYERS)
    n = layer_kinds(cut).count("rglru") * MESH_TRAIN_MB * MESH_TRAIN_STEPS
    want = dict(model_sharded_serve=dict(none, lru_scan=kinds.count("rglru"),  # the prefill
                                         decode_attention=kinds.count("localattn") * MESH_SERVE[2]),
                # remat "full": K3 twice an RG-LRU layer a microbatch, its backward once;
                # K1 20 at the one drain
                model_sharded_train=dict(none, posterior_grid_fleet=SWEEPS, lru_scan=2 * n,
                                         lru_scan_bwd=n))
    if model_launches != want:
        raise AssertionError(f"[mesh] launches {model_launches}, not {want}")
    lse_out_err, lse_err, lse_timing = k2_lse_checks()
    errs["decode_attention"] = max(errs["decode_attention"], lse_out_err, lse_err)
    timing["decode_attention"]["with_lse_ms"] = lse_timing["with_lse_ms"]
    dryrun_launches = phase_dryrun()
    want = dict(none, decode_attention=attention_layers(get_arch(DRYRUN_CELL[0])))
    if dryrun_launches != want:  # K2 once an attention layer, under local_map
        raise AssertionError(f"[dryrun-check] launches {dryrun_launches}, not {want}")
    total = lambda by_remat: {k: sum(c[k] for c in by_remat.values()) for k in none}
    by_path = dict(fleet=fleet_launches, serve=serve_launches, serve_smollm=smollm_launches,
                   serve_granite=granite_launches, serve_arctic=arctic_launches,
                   serve_whisper=whisper_launches, serve_internvl2=internvl_launches,
                   serve_yi=yi_launches, serve_command_r=command_r_launches,
                   serve_xlstm=xlstm_launches, service=service_launches,
                   partitioned=part_launches, partitioned_internvl2=vlm_launches,
                   dag=dag_launches, serve_tinyllama=tinyllama_launches,
                   example_partitioned=example_launches, checkpoint=ckpt_launches,
                   legacy=legacy_launches, fault_tolerance=fault_launches,
                   train_parity=parity_launches, train=train_launches, train_cli=cli_launches,
                   train_hybrid=hybrid_launches, train_remat=total(train_remat),
                   train_hybrid_remat=total(hybrid_remat), example_train_hetero=hetero_launches,
                   example_elastic=elastic_launches, **sharded_launches, **model_launches,
                   dryrun_check=dryrun_launches)
    stray = {p: c["lru_scan_bwd"] for p, c in by_path.items() if c.get("lru_scan_bwd")
             and p not in ("train_parity", "train_hybrid", "train_hybrid_remat",
                           "model_sharded_train")}
    if stray:
        raise AssertionError(f"K3's backward launched off the training paths: {stray}")
    kernels = [
        ("posterior_grid_fleet", "posterior_grid.cu", "src/repro/kernels/posterior_grid.py:108"),
        ("decode_attention", "decode_attention.cu", "src/repro/kernels/decode_attention.py:81"),
        ("lru_scan", "lru_scan.cu", "src/repro/kernels/lru_scan.py:52"),
        # the TPU kernel has no backward: the reference differentiates its scan
        ("lru_scan_bwd", "lru_scan.cu",
         "jax.grad of lax.associative_scan, src/repro/models/recurrent.py:344"),
    ]
    path_launches = lambda name: {p: c.get(name, 0) for p, c in by_path.items() if c.get(name)}
    say(json.dumps({"kernels": [dict(
        name=name,
        route="cuda",
        source=f"src/repro_torch/kernels/csrc/{source}",
        replaces=replaces,
        launches=sum(path_launches(name).values()),
        launches_by_path=path_launches(name),
        max_abs_err=errs[name],
        **timing[name],
    ) for name, source, replaces in kernels]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — report any phase's failure and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        sys.exit(1)
