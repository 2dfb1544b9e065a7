"""95th percentile of every gap between consecutive output tokens of
every request, both tokens inside the window (each token timed when the
engine step that served it returned)."""
from bench.metrics._common import gaps_in, percentile


def read(w):
    gaps = [g for r in w.recs.values()
            for g in gaps_in(r.token_times, w.t0, w.t1)]
    p = percentile(gaps, 95)
    return None if p is None else p * 1e3
