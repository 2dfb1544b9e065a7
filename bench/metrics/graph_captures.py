"""Decode-graph captures in the window (``EngineStats.graph_captures``):
each a key first met after the warm-up."""


def read(w):
    return float(w.delta("graph_captures"))
