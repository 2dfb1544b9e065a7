"""Prompt tokens of the requests prefilled in the window over the
window's seconds."""


def read(w):
    n = sum(len(w.recs[k].spec.prompt) for s in w.steps for k in s.admitted)
    return n / w.seconds if n else None
