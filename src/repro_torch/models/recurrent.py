"""Recurrent sequence mixers: the RG-LRU block (Griffin / RecurrentGemma).

The port's counterpart of the RG-LRU part of ``repro.models.recurrent``:
prefill and train run the linear recurrence h_t = a_t h_{t-1} + b_t through
``kernels.ops.lru_scan`` (K3); decode is its one elementwise step on the
float32 state.  mLSTM and sLSTM (the xLSTM family) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import ApplyCtx
from .params import P

_RGLRU_C = 8.0
_CONV_W = 4


def rglru_spec(cfg: ModelConfig) -> Dict[str, P]:
    d = cfg.d_model
    r = d  # lru width == d_model for recurrentgemma
    return {
        "w_in": P((d, r), ("embed", "rnn")),
        "w_gate": P((d, r), ("embed", "rnn")),
        "conv_w": P((_CONV_W, r), (None, "rnn"), scale=0.1),
        "conv_b": P((r,), ("rnn",), init="zeros"),
        "w_a": P((r, r), ("rnn", None), scale=0.01),
        "w_x": P((r, r), ("rnn", None), scale=0.01),
        "lam": P((r,), ("rnn",), init="ones"),  # softplus(lam) -> decay
        "w_out": P((r, d), ("rnn", "embed")),
    }


def init_rglru_cache(cfg: ModelConfig, batch: int, device) -> Dict[str, Tensor]:
    """The recurrent state and the conv history, float32 whatever the cache dtype."""
    r = cfg.d_model
    return {
        "h": torch.zeros((batch, r), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_W - 1, r), dtype=torch.float32, device=device),
    }


def _rglru_gates(params, u: Tensor) -> Tuple[Tensor, Tensor]:
    """a_t (decay) and b_t (input) of the linear recurrence from u (B, T, R), f32."""
    r_gate = torch.sigmoid(u @ params["w_a"])  # recurrence gate
    i_gate = torch.sigmoid(u @ params["w_x"])  # input gate
    log_a = -_RGLRU_C * F.softplus(params["lam"]) * r_gate.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * (i_gate.float() * u.float())


def _causal_conv(params, u: Tensor, state: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv of width 4 over u (B, T, R) after the history
    ``state`` (B, 3, R).  Returns the output in u's dtype and the new history
    in float32."""
    b, t, r = u.shape
    if state is None:
        hist = torch.zeros((b, _CONV_W - 1, r), dtype=u.dtype, device=u.device)
    else:
        hist = state.to(u.dtype)
    ext = torch.cat([hist, u], dim=1)  # (B, T+3, R)
    out = torch.zeros_like(u)
    for w in range(_CONV_W):
        out = out + ext[:, w : w + t] * params["conv_w"][_CONV_W - 1 - w]
    out = out + params["conv_b"]
    return out, ext[:, -(_CONV_W - 1):].float()


def rglru_block(
    cfg: ModelConfig,
    params: Dict[str, Tensor],
    x: Tensor,
    *,
    ctx: ApplyCtx,
    cache: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """Returns (y, cache); the cache's state is written in place in prefill
    and decode."""
    u = x @ params["w_in"]  # (B, T, R)
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")

    u, new_conv = _causal_conv(params, u, None if cache is None else cache["conv"])
    a, bb = _rglru_gates(params, u)  # (B, T, R) f32

    if ctx.mode == "decode":
        assert cache is not None
        h_last = a[:, 0] * cache["h"] + bb[:, 0]
        y_rnn = h_last[:, None, :]
    else:
        y_rnn = ops.lru_scan(a, bb, None if cache is None else cache["h"])
        h_last = y_rnn[:, -1]
    if cache is not None and ctx.mode in ("prefill", "decode"):
        cache["h"].copy_(h_last)
        cache["conv"].copy_(new_conv)

    y = (gate.float() * y_rnn).to(x.dtype) @ params["w_out"]
    return y, cache
