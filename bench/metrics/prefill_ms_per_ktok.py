"""Prefill wall time per thousand prefilled prompt tokens in the window
(the engine's prefill seconds, each call ending in a device sync, over
its prefilled tokens)."""


def read(w):
    n = w.delta("prefill_tokens")
    return 1e3 * w.delta("prefill_s") / (n / 1e3) if n else None
