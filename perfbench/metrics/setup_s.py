"""Process start to the window's start: kernel load, inputs made on the card, shapes warmed."""


def read(rec, cfg, mix):
    return rec.setup_s
