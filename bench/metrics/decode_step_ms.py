"""Mean wall time of a decode step in the window: the engine's decode
seconds (each step ends in the token readback's device sync) over its
decode steps."""


def read(w):
    n = w.delta("steps")
    return 1e3 * w.delta("decode_s") / n if n else None
