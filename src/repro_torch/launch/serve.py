"""Serving demo: ``python -m repro_torch.launch.serve --arch recurrentgemma-2b``

The port's counterpart of ``repro.launch.serve``'s single-shot latency demo:
prefill a batch of random prompts and decode greedily, reporting prefill
time and decode time per token.  The model is reduced unless ``--full`` is
given, and runs on the card unless ``--device`` names another device.  The
reference's partitioned-serving mode (``--rounds``, ``--serve-smoke``) needs
the serving service, which is not ported yet.
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    # the reference's partitioned-serving flags, refused below
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--drain-every", type=int, default=4)
    ap.add_argument("--drift-threshold", type=float, default=0.05)
    ap.add_argument("--serve-smoke", action="store_true")
    args = ap.parse_args(argv)
    if args.rounds > 0 or args.serve_smoke:
        raise SystemExit("partitioned serving (--rounds, --serve-smoke) needs the serving "
                         "service (ROADMAP item 9), which is not ported yet")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = model_zoo.init_model_params(cfg, seed=0, device=resolve_device(args.device))
    out = latency_demo(cfg, params, batch=args.batch, prompt_len=args.prompt_len,
                       gen_len=args.gen_len)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len}")
    print(f"prefill: {out['prefill_ms']:.1f} ms   decode: {out['decode_ms']:.1f} ms/token")
    print("generated token ids (seq 0):", out["tokens"][0].cpu().numpy())


if __name__ == "__main__":
    main()
