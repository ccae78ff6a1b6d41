"""Tokens generated for this card's requests, per second of the window."""
from perfbench.readers import rate


def read(rec, cfg, mix):
    return rate(rec, "tokens")
