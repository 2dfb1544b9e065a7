"""Share of the traced span in which no kernel, copy or set ran on the
device (the profiler's device events after the span's lead marker,
merged). None when the trace holds fewer events of a counted kernel
than its wrapper launched (``Trace.complete``): a trace that lost
events would read the device idler than it was."""


def read(w):
    t = w.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    if not t.complete or not all(t.complete.values()):
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
