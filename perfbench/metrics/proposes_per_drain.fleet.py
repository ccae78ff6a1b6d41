"""Solves per drain over the window (``ServiceLoop.counters()`` before and after it)."""


def read(rec, cfg, mix):
    drains = rec.counters.get("drains")
    return rec.counters["proposes"] / drains if drains else None
