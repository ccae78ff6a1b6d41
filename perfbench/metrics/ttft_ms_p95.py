"""95th percentile over all requests of round start (the split read) to the first token on the host."""
from perfbench.readers import span_ms


def read(rec, cfg, mix):
    return span_ms(rec, "ttft", 0.95)
