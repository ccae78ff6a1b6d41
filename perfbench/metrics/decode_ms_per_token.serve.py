"""The rounds' decode time over their decode steps, all rounds of the window."""


def read(rec, cfg, mix):
    steps = rec.work.get("decode_steps")
    return 1e3 * sum(rec.durations("decode")) / steps if steps else None
