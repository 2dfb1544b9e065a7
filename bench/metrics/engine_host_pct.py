"""Share of the window outside the engine's model calls: 100 x (1 -
(prefill seconds + decode seconds) / window), the engine's own
``EngineStats`` (each call ends in a device sync)."""


def read(w):
    model_s = w.delta("prefill_s") + w.delta("decode_s")
    return 100.0 * (1.0 - model_s / w.seconds)
