"""Median of an async solve's dispatch (``last_dispatch[0]``) to its publish (``poll()`` True)."""
from perfbench.readers import span_ms


def read(rec, cfg, mix):
    return span_ms(rec, "publish")
