"""K1's bound at its launch shape (counts/k1.py) over its traced device time, in percent."""
from perfbench.readers import roofline_pct


def read(rec, cfg, mix):
    return roofline_pct(rec, "posterior_grid_fleet", "k1")
