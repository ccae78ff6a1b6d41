"""Serving driver: ``python -m repro_torch.launch.serve --arch recurrentgemma-2b``

The port's counterpart of ``repro.launch.serve``.  Two modes:

  * **single-shot latency demo** (default): prefill a batch of random prompts
    and decode greedily, reporting prefill time and decode time per token;
  * **partitioned serving** (``--rounds N`` or ``--serve-smoke``): each
    round's request batch is split across heterogeneous (simulated) replicas
    by the always-on estimation service (``repro_torch.serve.ServiceLoop``).
    The driver reads the last-good split from the service's host slot,
    quantizes it to requests, really serves replica 0's shard on the model
    (prefill and greedy decode), and pushes every replica's measured time
    back into the service's ring; the service drains every
    ``--drain-every`` rounds and re-solves the split only when the posterior
    moved.

The model is reduced unless ``--full`` is given, and runs on the card unless
``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch, reduced
from ..device import resolve_device
from ..models import model_zoo
from ..models.layers import ApplyCtx
from ..train import serve_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def latency_demo(cfg, params, *, batch: int, prompt_len: int, gen_len: int, seed: int = 0):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (numpy seed
    ``seed``), then decode ``gen_len - 1`` greedy tokens, with a float32
    cache as the reference.  Returns a dict of prefill_ms, decode_ms (per
    token), the tokens (B, gen_len) and the cache, on the parameters' device."""
    device = params["embed"].device
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                             dtype=torch.int32, device=device)
    cache = model_zoo.init_cache(cfg, batch, prompt_len + gen_len + 8, torch.float32,
                                 device=device)
    prefill = serve_step.make_prefill_step(cfg, ctx=ApplyCtx(mode="prefill"))
    decode = serve_step.make_decode_step(cfg, ctx=ApplyCtx(mode="decode"))

    _sync(device)
    t0 = time.perf_counter()
    token, cache = prefill(params, {"tokens": tokens}, cache)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    outs = [token]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        token, cache = decode(params, token, cache)
        outs.append(token)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return dict(prefill_ms=t_prefill * 1e3, decode_ms=t_decode / max(gen_len - 1, 1) * 1e3,
                tokens=torch.cat(outs, dim=1), cache=cache)


def partitioned_serving(cfg, params, args) -> dict:
    """Replica-partitioned serving fed by the always-on estimator service.

    Returns the service's counters and config, every published split, the
    requests of every round by replica, the final split and the oracle
    makespans (under the simulated replicas' true parameters) of the equal
    and the learned split.
    """
    from .. import sched, serve
    from ..distributed.simulated_cluster import SimulatedCluster, WorkerSpec

    device = params["embed"].device
    prefill = serve_step.make_prefill_step(cfg, ctx=ApplyCtx(mode="prefill"))
    decode = serve_step.make_decode_step(cfg, ctx=ApplyCtx(mode="decode"))

    # Heterogeneous replica speeds the estimator must discover online.
    rng = np.random.default_rng(0)
    specs = [WorkerSpec(mu=float(m), sigma=0.1 * float(m))
             for m in np.linspace(2.0, 6.0, args.replicas)]
    cluster = SimulatedCluster(specs, seed=0)

    config = serve.ServeConfig(
        sched=sched.SchedulerConfig(
            n_iters=4, grid_size=64, num_points=128, opt_steps=40,
            mu_guess=float(np.mean([s.mu for s in specs])),
        ),
        capacity=2 * args.drain_every,
        drift_threshold=args.drift_threshold,
        max_staleness=8,
    )
    loop = serve.ServiceLoop(args.replicas, config=config, seed=1, device=device)

    max_len = args.prompt_len + args.gen_len + 8
    published, rounds = [], []
    print("round | requests/replica | batch latency | service")
    for rnd in range(args.rounds):
        # Non-blocking read of the last-good split; never waits on a sweep.
        fr = loop.fractions()
        counts = sched.quantize_fractions(
            fr, args.batch, sched.unit_params(loop.state.sched),
            objective=config.sched.objective,
        )
        fr_actual = counts / counts.sum()
        rounds.append(counts)

        # Really serve replica 0's shard on the local model (each replica
        # would run its own shard the same way).
        toks = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (int(counts[0]), args.prompt_len)),
            dtype=torch.int32, device=device,
        )
        cache = model_zoo.init_cache(cfg, int(counts[0]), max_len, torch.float32, device=device)
        token, cache = prefill(params, {"tokens": toks}, cache)
        for _ in range(args.gen_len - 1):
            token, cache = decode(params, token, cache)
        _sync(device)

        # Telemetry: measured (simulated) per-replica latency for its share.
        times = cluster.step_times(fr_actual)
        loop.push(fr_actual, times, valid=np.isfinite(times))
        note = ""
        if (rnd + 1) % args.drain_every == 0:
            info = loop.tick()
            note = (f"drained={info.drained} drift={float(info.drift):.3f} "
                    f"proposed={info.proposed}")
            if info.proposed:
                published.append(loop.fractions().copy())
        lat = float(np.max(times[np.isfinite(times)]))
        print(f"  {rnd:3d} | {counts} | {lat:6.2f}s | {note}")

    c = loop.counters()
    fr = loop.fractions()
    eq = cluster.oracle_makespan(np.full(args.replicas, 1.0 / args.replicas))
    learned = cluster.oracle_makespan(fr)
    print(f"learned split {np.round(fr, 3)}  "
          f"oracle makespan equal={eq:.2f}s learned={learned:.2f}s")
    print(f"service: {c['pushes']} pushes, {c['drains']} drains, "
          f"{c['proposes']} proposes "
          f"(skip rate {1.0 - c['proposes'] / max(c['drains'], 1):.2f}), "
          f"{c['dropped']} dropped")
    return dict(counters=c, config=config, published=published, counts=rounds,
                fractions=fr.copy(), oracle_equal=eq, oracle_learned=learned)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=0,
                    help="partitioned-serving rounds via repro_torch.serve "
                         "(0 = single-shot latency demo)")
    ap.add_argument("--drain-every", type=int, default=4,
                    help="service drain cadence in rounds")
    ap.add_argument("--drift-threshold", type=float, default=0.05,
                    help="posterior drift gate for re-solving the split")
    ap.add_argument("--serve-smoke", action="store_true",
                    help="tiny fixed partitioned-serving run: reduced arch, few "
                         "rounds, exit 1 unless the service proposed at least "
                         "once and skipped at least once")
    args = ap.parse_args(argv)

    if args.serve_smoke:
        args.arch = "smollm-135m"
        args.reduced = True
        args.batch = 8
        args.prompt_len = 8
        args.gen_len = 4
        args.rounds = 12
        args.drain_every = 2
        args.replicas = 3
        # Steady-state skips must show within few drains: gate a little above
        # the converged-posterior jitter of this fixed-seed workload.
        args.drift_threshold = 0.12

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = model_zoo.init_model_params(cfg, seed=0, device=resolve_device(args.device))
    if args.rounds > 0:
        result = partitioned_serving(cfg, params, args)
        if args.serve_smoke:
            c = result["counters"]
            ok = c["proposes"] >= 1 and c["drains"] > c["proposes"]
            print(f"serve-smoke {'OK' if ok else 'FAILED'}")
            if not ok:
                raise SystemExit(1)
        return result
    out = latency_demo(cfg, params, batch=args.batch, prompt_len=args.prompt_len,
                       gen_len=args.gen_len)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len}")
    print(f"prefill: {out['prefill_ms']:.1f} ms   decode: {out['decode_ms']:.1f} ms/token")
    print("generated token ids (seq 0):", out["tokens"][0].cpu().numpy())
    return dict(out, cfg=cfg, params=params)  # a caller may run more steps on the cache


if __name__ == "__main__":
    main()
