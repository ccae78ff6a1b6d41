"""K2's bytes bound at each launch's shape (counts/k2.py) over its traced device time
(both of its kernels), in percent."""
from perfbench.readers import roofline_pct


def read(rec, cfg, mix):
    return roofline_pct(rec, "decode_attention", "k2", per_call=2)
