"""Driver of partitioned serving under the estimation service.

Replica 0 of R replicas serves on the card: each round reads the service's
published split, quantizes the round's requests over the replicas
(``sched.quantize_fractions`` with the current beliefs), prefills replica
0's share of prompts (``serve_step.make_prefill_step``: the model zoo's
``prefill`` and a greedy pick), reads the first tokens on the host, decodes
greedily (``make_decode_step``) and reads the tokens back.  Every replica's
time for its share is drawn from its true model (a copy of the port's
``SimulatedCluster`` arithmetic: N(f^alpha mu, (f^beta sigma)^2) on the
host) and pushed into the service, which drains every ``drain_every``
rounds and re-solves when the posterior drifted.  This is the loop of
``repro_torch.launch.serve.partitioned_serving``, with its constants taken
from the mix.

Weights are drawn on the card from the seed in the serving type, one call
a leaf of the model's parameter tree (the layers stacked), and handed to
the program and to the reference alike; prompts are drawn on the card from
the seed.  The replicas' times and the service's own draws come from the
mix's ``size_seed``, so every seed serves the same sequence of batch sizes.

Spans: ``round``, ``quantize`` (split read to counts), ``prefill`` (to the
first tokens on the host), ``decode`` (the rest of the tokens on the host),
``ttft`` one per request (round start to its first token on the host).
Work: ``attempted`` and ``completed`` requests, ``tokens``, ``decode_steps``.
Launch shapes: ``model`` calls, ``decode_attention`` per layer and step.

Check: for a sample of the finished requests drawn from the seed, the
reference runs once over each prompt and its served tokens, and
``token_gap`` is the widest gap by which a served token's logit lies below
the reference's best at its position.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.drivers.fleet import seeds
from perfbench.harness import log
from perfbench.reference import llama


class Replicas:
    """Each replica's true (mu, sigma, alpha, beta); the time for a share f
    is max(N(f^alpha mu, (f^beta sigma)^2), 1e-6), drawn on the host."""

    def __init__(self, mus, sigma_share, alpha, beta, seed):
        self.mu = np.asarray(mus, np.float64)
        self.sigma = sigma_share * self.mu
        self.alpha, self.beta = alpha, beta
        self.rng = np.random.default_rng(seed)

    def step_times(self, fracs) -> np.ndarray:
        out = np.zeros(len(self.mu))
        for i in range(len(self.mu)):
            f = max(float(fracs[i]), 1e-6)
            out[i] = max(self.rng.normal(f ** self.alpha * self.mu[i],
                                         f ** self.beta * self.sigma[i]), 1e-6)
        return out


def model_config(cfg):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=cfg["name"], family="dense", num_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], tie_embeddings=cfg["tie_word_embeddings"],
        act={"silu": "swiglu"}[cfg["hidden_act"]], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], dtype=cfg["torch_dtype"])


def make_weights(mcfg, seed: int, device):
    """The parameter tree of the model's spec, each leaf one draw on the device."""
    import torch
    from repro_torch.models import model_zoo
    from repro_torch.models.params import tree_map

    dtype = model_zoo.model_dtype(mcfg)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(p):
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        return torch.randn(p.shape, generator=gen, dtype=dtype, device=device).mul_(p.scale)

    return tree_map(make, model_zoo.model_spec(mcfg))


def run(rec, cfg, mix, seed, device):
    import torch
    from repro_torch import sched, serve
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import ApplyCtx
    from repro_torch.train import serve_step

    s_weights, s_tokens = seeds(seed, 2)
    # The sizes (each round's split, from the replicas' times and the
    # service's draws) are the mix's, alike for every seed.
    s_loop, s_replicas = seeds(mix["size_seed"], 2)
    mcfg = model_config(cfg)
    params = make_weights(mcfg, s_weights, device)
    prefill = serve_step.make_prefill_step(mcfg, ctx=ApplyCtx(mode="prefill"))
    decode = serve_step.make_decode_step(mcfg, ctx=ApplyCtx(mode="decode"))
    n_rep, n_req = mix["replicas"], mix["requests_per_round"]
    prompt, gen = mix["prompt_len"], mix["gen_len"]
    replicas = Replicas(np.linspace(*mix["replica_mu"], n_rep), mix["sigma_share"],
                        mix["alpha"], mix["beta"], s_replicas)
    svc = mix["service"]
    config = serve.ServeConfig(
        sched=sched.SchedulerConfig(n_iters=svc["n_iters"], grid_size=svc["grid_size"],
                                    num_points=svc["num_points"], opt_steps=svc["opt_steps"],
                                    mu_guess=float(np.mean(replicas.mu))),
        capacity=2 * mix["drain_every"], drift_threshold=mix["drift_threshold"],
        max_staleness=mix["max_staleness"])
    loop = serve.ServiceLoop(n_rep, config=config, seed=s_loop, device=device)
    tok_gen = torch.Generator(device=device).manual_seed(s_tokens)
    h, kvh = mcfg.num_heads, mcfg.num_kv_heads
    hd = mcfg.resolved_head_dim
    served = []  # (prompts on the device, served tokens on the host)
    state = dict(round=0)

    def split():
        fr = loop.fractions()
        return sched.quantize_fractions(fr, n_req, sched.unit_params(loop.state.sched),
                                        objective=config.sched.objective)

    def feed(counts):
        times = replicas.step_times(counts / counts.sum())
        loop.push(counts / counts.sum(), times, valid=np.isfinite(times))
        state["round"] += 1
        if state["round"] % mix["drain_every"] == 0:
            loop.tick()

    def serve_round():
        t0 = time.perf_counter()
        counts = split()
        b = int(counts[0])
        q1 = time.perf_counter()
        toks = torch.randint(0, mcfg.vocab_size, (b, prompt), generator=tok_gen, device=device,
                             dtype=torch.int32)
        cache = model_zoo.init_cache(mcfg, b, prompt + gen + mix["cache_spare"], torch.float32,
                                     device=device)
        p0 = time.perf_counter()
        token, cache = prefill(params, {"tokens": toks}, cache)
        first = token.cpu()
        t_first = time.perf_counter()
        outs = []
        for _ in range(gen - 1):
            token, cache = decode(params, token, cache)
            outs.append(token)
        out = torch.cat([first] + ([torch.cat(outs, dim=1).cpu()] if outs else []), dim=1)
        t_end = time.perf_counter()
        del cache
        feed(counts)
        rec.add_span("quantize", t0, q1)
        rec.add_span("prefill", p0, t_first)
        rec.add_span("decode", t_first, t_end)
        rec.add_span("round", t0, time.perf_counter())
        for _ in range(b):
            rec.add_span("ttft", t0, t_first)
        if rec.measuring:
            served.append((toks, out))
            rec.add_launch("model", ("prefill", b, prompt, 0))
            for i in range(gen - 1):
                rec.add_launch("model", ("decode", b, 1, prompt + i))
                rec.add_launch("decode_attention", (b, h, kvh, hd, prompt + i + 1),
                               mcfg.num_layers)
        rec.add_work("completed", b)
        rec.add_work("tokens", b * gen)
        rec.add_work("decode_steps", gen - 1)
        return b

    # Set-up: the service learns the replicas from simulated rounds, then
    # one served round warms the model's shapes.
    log("weights made")
    for _ in range(mix["setup_rounds"]):
        feed(split())
    log(f"service fed, split {loop.fractions()}")
    for _ in range(mix["warm_rounds"]):
        serve_round()
    log("warm round served")
    with rec.window():
        while not rec.expired():
            n = serve_round()
            rec.add_work("attempted", n)
    return dict(served=served, params=params, h=h)


def check(samples, cfg, mix, seed, control=False):
    """``token_gap`` over the sampled requests; with ``control`` the
    reference with fp8 weights (the precision below the configuration's
    bfloat16) stands in the program's place, and its own greedy choice at
    each position of the same prompts and tokens is judged."""
    import torch

    pick = np.random.default_rng(seeds(seed, 5)[4])
    served = samples["served"]
    rows = [(r, j) for r, (_, out) in enumerate(served) for j in range(out.shape[0])]
    if not rows:
        raise RuntimeError("no request finished in the window")
    take = pick.choice(len(rows), size=min(mix["check"]["requests"], len(rows)), replace=False)
    chosen = [rows[i] for i in sorted(take)]
    prompt, gen = mix["prompt_len"], mix["gen_len"]
    params = samples["params"]
    dev = params["embed"].device
    gap = 0.0
    for c0 in range(0, len(chosen), 8):
        part = chosen[c0:c0 + 8]
        toks = torch.stack([torch.cat([served[r][0][j].to(dev),
                                       served[r][1][j, :-1].to(dev, torch.int32)]) for r, j in part])
        tokens_out = torch.stack([served[r][1][j] for r, j in part]).to(dev).long()
        at = torch.arange(prompt - 1, prompt - 1 + gen, device=dev)
        want = llama.logits_at(params, toks, cfg, at)
        if control:
            low = llama.logits_at(params, toks, cfg, at, weight=llama.fp8_round_trip)
            tokens_out = low.argmax(-1)
            del low
        best = want.max(-1).values
        got = want.gather(-1, tokens_out[..., None])[..., 0]
        gap = max(gap, float((best - got).max()))
        del want
    return dict(token_gap=gap)
