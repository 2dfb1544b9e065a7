"""90th percentile, over every request whose first token came in the
window, of that token's time less the moment its client sent the
request (the engine's ``Request`` timestamps; ``arrival_t`` is the send
time)."""
from bench.metrics._common import percentile


def read(w):
    ttft = [r.req.first_token_t - r.req.arrival_t for r in w.recs.values()
            if r.req.first_token_t is not None
            and w.t0 <= r.req.first_token_t <= w.t1]
    p = percentile(ttft, 90)
    return None if p is None else p * 1e3
