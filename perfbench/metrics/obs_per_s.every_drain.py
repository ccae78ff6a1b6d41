"""Worker observations whose cycle ended with quantized counts, per second of the window."""
from perfbench.readers import rate


def read(rec, cfg, mix):
    return rate(rec, "obs")
