"""Process start to the start of the measured window (host clock)."""


def read(w):
    return w.setup_s
