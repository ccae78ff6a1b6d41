"""Plain float32 forward of a dense Llama-architecture decoder (Yi-9B).

Written from the published architecture (arXiv:2403.04652; Llama's
pre-norm decoder): RMSNorm, grouped-query attention with rotary embeddings
on the two halves of each head, a SwiGLU MLP, an untied output head.  One
departure, kept because it is the program's definition of the model: the
token embeddings are scaled by sqrt(hidden_size), as the reference package
does for every family.

It imports nothing of the program and reads the weights from the same
parameter tree the benchmark made (``{"embed", "final_norm", "cycles":
[block], "head"}``, the block's leaves stacked over layers), upcasting one
layer at a time.  ``weight`` maps each weight to what the forward uses:
float32 by default, an fp8 round trip for the check's control.  No cache,
no kernel, no batching across requests beyond one stacked batch; attention
runs a sequence at a time.  TF32 is off while it runs.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

F32 = torch.float32


@contextlib.contextmanager
def full_float32():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def as_f32(w: torch.Tensor) -> torch.Tensor:
    return w.to(F32)


def fp8_round_trip(w: torch.Tensor) -> torch.Tensor:
    """``w`` stored as float8 e4m3 with one scale per output column (the last
    axis), read back in float32."""
    w = w.to(F32)
    reduce = tuple(range(w.ndim - 1))
    scale = torch.clamp(w.abs().amax(dim=reduce, keepdim=True), min=1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).to(F32) * scale


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.to(F32)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits_at(params, tokens: torch.Tensor, cfg: dict, at: torch.Tensor,
              weight: Callable = as_f32) -> torch.Tensor:
    """Logits (B, len(at), V) at positions ``at`` of token rows (B, T)."""
    d = cfg["hidden_size"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps, theta = d // h, cfg["rms_norm_eps"], cfg["rope_theta"]
    b, t = tokens.shape
    pos = torch.arange(t, device=tokens.device)
    mask = torch.full((t, t), float("-inf"), device=tokens.device).triu(1)
    with full_float32(), torch.no_grad():
        x = weight(params["embed"])[tokens.long()] * float(d) ** 0.5
        blk = params["cycles"][0]
        for i in range(cfg["num_hidden_layers"]):
            w = lambda *path: weight(_leaf(blk, path)[i])
            y = rmsnorm(x, w("ln1", "scale"), eps)
            q = rope(torch.einsum("btd,dhk->bthk", y, w("attn", "wq")), pos, theta)
            k = rope(torch.einsum("btd,dhk->bthk", y, w("attn", "wk")), pos, theta)
            v = torch.einsum("btd,dhk->bthk", y, w("attn", "wv"))
            out = torch.empty_like(q)
            for s in range(b):  # one sequence at a time: (H, T, T) scores
                qs = q[s].transpose(0, 1) * hd ** -0.5
                ks = k[s].transpose(0, 1).repeat_interleave(h // kvh, dim=0)
                vs = v[s].transpose(0, 1).repeat_interleave(h // kvh, dim=0)
                p = torch.softmax(qs @ ks.transpose(1, 2) + mask, dim=-1)
                out[s] = (p @ vs).transpose(0, 1)
            x = x + torch.einsum("bthk,hkd->btd", out, w("attn", "wo"))
            y = rmsnorm(x, w("ln2", "scale"), eps)
            gate = y @ w("ffn", "wg")
            x = x + (torch.nn.functional.silu(gate) * (y @ w("ffn", "wi"))) @ w("ffn", "wo")
        y = rmsnorm(x[:, at], weight(params["final_norm"]["scale"]), eps)
        return y @ weight(params["head"])


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree
