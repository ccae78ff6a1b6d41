"""Median of a tick's host time less its dispatch: drain to the flag read."""
from perfbench.readers import span_ms


def read(rec, cfg, mix):
    return span_ms(rec, "advance")
