"""Median of a round's prefill, to its first tokens on the host."""
from perfbench.readers import span_ms


def read(rec, cfg, mix):
    return span_ms(rec, "prefill")
