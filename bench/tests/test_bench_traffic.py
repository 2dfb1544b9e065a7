"""The one traffic generator: stratified log-uniform sizes, the same
multiset of sizes in every seed, token ids and greedy/sampled requests
fixed by (seed, index), and the closed loop that sends a client's next
request when its last one finishes."""
import math
from pathlib import Path

import numpy as np
import pytest

from bench.traffic import Traffic, load_mix, log_uniform_pool

MIXES = Path(__file__).resolve().parents[1] / "mixes"
BIG_SEED = 2 ** 31 + 987654321


def test_pool_is_stratified_log_uniform():
    pool = log_uniform_pool(128, 768, 256)
    assert pool.min() >= 128 and pool.max() <= 768
    assert np.all(np.diff(pool) >= 0)
    # the log-uniform law's mean, (hi - lo) / ln(hi / lo)
    assert abs(pool.mean() - 640 / math.log(6)) < 2


@pytest.mark.parametrize("name,prompt,output", [("chat", 357, 108),
                                                 ("longprompt", 2043, 8.6)])
def test_mix_means(name, prompt, output):
    mix = load_mix(MIXES / f"{name}.json")
    t = Traffic(mix, BIG_SEED, 1000)
    sizes = np.array([t.sizes(k) for k in range(mix["pool"])])
    assert abs(sizes[:, 0].mean() - prompt) / prompt < 0.01
    assert abs(sizes[:, 1].mean() - output) / output < 0.02


def test_every_seed_sends_the_same_sizes_in_another_order():
    mix = load_mix(MIXES / "chat.json")
    a, b = Traffic(mix, 1, 1000), Traffic(mix, BIG_SEED, 1000)
    for block in range(3):
        ks = range(block * mix["pool"], (block + 1) * mix["pool"])
        sa = [a.sizes(k) for k in ks]
        sb = [b.sizes(k) for k in ks]
        assert sorted(x for x, _ in sa) == sorted(x for x, _ in sb)
        assert sorted(y for _, y in sa) == sorted(y for _, y in sb)
        assert sa != sb


def test_requests_are_fixed_by_seed_and_index():
    mix = load_mix(MIXES / "longprompt.json")
    t1, t2 = Traffic(mix, BIG_SEED, 151936), Traffic(mix, BIG_SEED, 151936)
    r = t1.request(5)
    assert r == t2.request(5)
    assert r != Traffic(mix, BIG_SEED + 1, 151936).request(5)
    assert len(r.prompt) == t1.sizes(5)[0]
    assert r.max_new_tokens == t1.sizes(5)[1]
    assert 0 <= min(r.prompt) and max(r.prompt) < 151936
    assert [t1.request(k).greedy for k in range(4)] == [True, False] * 2
    assert t1.request(1).temperature == mix["temperature"]


class FakeEngine:
    """Serves one token a step to every submitted request, and finishes a
    request at its ``max_new_tokens``."""

    def __init__(self):
        from repro_torch.runtime.request import RequestState
        self.state = RequestState
        self.live = []

    def submit(self, req):
        self.live.append(req)

    def step(self):
        for r in self.live:
            if r.admit_t is None:
                r.admit_t = 0.0
                r.state = self.state.RUNNING
            r.output.append(7)
            if r.first_token_t is None:
                r.first_token_t = 0.0
            if len(r.output) >= r.max_new_tokens:
                r.state = self.state.FINISHED
                r.finish_t = 0.0
        self.live = [r for r in self.live if r.state != self.state.FINISHED]
        return True


def test_closed_loop_sends_when_the_last_request_finishes():
    from bench.harness import Loop
    mix = dict(load_mix(MIXES / "chat.json"),
               output={"law": "log_uniform", "lo": 2, "hi": 5})
    loop = Loop(FakeEngine(), Traffic(mix, BIG_SEED, 100), clients=3)
    assert loop.next_index == 3
    for _ in range(12):
        rec = loop.step()
        # one token a step to each of the three clients' requests
        assert len(rec.tokens) == 3
    # every client always has exactly one request in flight
    assert len(loop.active) == 3
    by_client = {}
    for k, r in sorted(loop.recs.items()):
        by_client.setdefault(r.client, []).append(r)
    for reqs in by_client.values():
        for prev, nxt in zip(reqs, reqs[1:]):
            assert prev.finished and len(prev.req.output) == \
                prev.spec.max_new_tokens
            # the next request was sent right after the step that
            # finished the previous one
            assert nxt.sent >= prev.token_times[-1]
            assert nxt.req.arrival_t == nxt.sent
