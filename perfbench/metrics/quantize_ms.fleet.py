"""Median of ``quantize_fractions(split, 8 K)``: the split rounded to counts (largest remainder)."""
from perfbench.readers import span_ms


def read(rec, cfg, mix):
    return span_ms(rec, "quantize")
