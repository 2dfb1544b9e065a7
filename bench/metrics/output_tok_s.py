"""Generated tokens emitted in the window over the window's seconds."""


def read(w):
    n = sum(len(s.tokens) for s in w.steps)
    return n / w.seconds if n else None
