"""Model FLOPs of the window's prefills and decode steps (``counts/dense_lm.py``)
over the window's seconds times the H100's dense bf16 peak, in percent."""
from perfbench.counts import dense_lm


def read(rec, cfg, mix):
    calls = rec.launches.get("model")
    if not calls:
        return None
    flops = sum(dense_lm.flops(cfg, b, new, prior) * n for (_, b, new, prior), n in calls)
    return 100.0 * flops / (rec.window_s * dense_lm.BF16_FLOPS)
