"""Port parity: the serving engine. The port's ``ServingEngine`` (CPU, f32)
gives the same greedy token lists as the JAX ``ServingEngine`` with no
plan policy, on the same weights and the same request set (staggered
arrivals, one request capped by length); plus the port's own runtime
checks (batched vs single prefill, slot churn, run(), sampling)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro.runtime import BatchScheduler as JaxScheduler  # noqa: E402
from repro.runtime import KVCacheManager as JaxKV  # noqa: E402
from repro_torch.runtime import (BatchScheduler, KVCacheManager,  # noqa: E402
                                 Request, RequestState, ServingEngine,
                                 sample)


def _drive(eng, req_cls, prompts, max_new):
    """Submit the first request, step twice, then submit the rest (they
    land mid-flight in free slots); run to the end."""
    reqs = [req_cls(prompt=p, max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    eng.submit(reqs[0])
    eng.step()
    eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    while eng.step() or eng.waiting:
        pass
    return reqs


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2-1.5b"])
def test_engine_tokens_match_jax_engine(arch):
    max_context = 32
    jeng = JaxEngine(jax_smoke(arch), num_slots=2, max_context=max_context,
                     dtype=jnp.float32, plan_policy=None)
    cfg = get_smoke_config(arch)
    teng = ServingEngine(
        cfg, params=params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jeng.params)),
        num_slots=2, max_context=max_context, dtype=torch.float32,
        device="cpu")
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(0, cfg.vocab_size, size=n))
               for n in (5, 9, 28, 1)]
    # the 28-token prompt reaches max_context before its 10 tokens
    max_new = [6, 6, 10, 3]
    rj = _drive(jeng, JaxRequest, prompts, max_new)
    rt = _drive(teng, Request, prompts, max_new)
    for a, b in zip(rt, rj):
        assert a.output == b.output, (a.output, b.output)
        assert a.state.value == b.state.value
    assert rt[2].state == RequestState.LENGTH_CAPPED
    assert teng.stats.decode_tokens == jeng.stats.decode_tokens
    assert teng.stats.prefill_tokens == jeng.stats.prefill_tokens


def test_batched_prefill_close_to_single():
    """N same-bucket requests in ONE prefill call give caches allclose to
    N single-request prefills, and the same tokens (allclose, not bitwise:
    see ROADMAP Queue 3). Dense model: capacity MoE is not batch
    invariant, since the batch sets the expert capacity and so the drops."""
    cfg = get_smoke_config("qwen2-1.5b")
    eng_b = ServingEngine(cfg, num_slots=3, max_context=64, device="cpu")
    eng_s = ServingEngine(cfg, params=eng_b.params, num_slots=3,
                          max_context=64, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(0, cfg.vocab_size, size=n))
               for n in (5, 7, 9)]
    for p in prompts:
        eng_b.submit(Request(prompt=p, max_new_tokens=4))
    plan = eng_b._admit()
    assert plan.num_prefilled == 3 and len(plan.prefills) == 1
    reqs_s = [Request(prompt=p, max_new_tokens=4) for p in prompts]
    for slot, r in enumerate(reqs_s):
        eng_s._prefill_one(slot, r)
    for cb, cs in zip(eng_b.kv.caches, eng_s.kv.caches):
        for slot, n in enumerate(len(p) - 1 for p in prompts):
            for name in ("k", "v"):
                np.testing.assert_allclose(cb[name][slot, :n].numpy(),
                                           cs[name][slot, :n].numpy(),
                                           rtol=1e-5, atol=1e-5)
        assert torch.equal(cb["index"], cs["index"])
    eng_b.run()
    eng_s.run()
    assert [len(r.output) for r in reqs_s] == [4, 4, 4]
    assert eng_b.kv.stats.peak_live == 3


@pytest.mark.parametrize("admission,budget", [("fcfs", None), ("spf", None),
                                              ("token_budget", 40),
                                              ("fcfs", 30)])
def test_admission_matches_jax_scheduler(admission, budget):
    """The copied scheduler admits, rejects and buckets exactly as the
    reference does, step after step, over a ledger-only KV manager."""
    rng = np.random.RandomState(5)
    sizes = [3, 70, 12, 1, 200, 33, 9, 140]
    jw = [JaxRequest(prompt=list(range(n)), max_new_tokens=2,
                     arrival_t=float(i)) for i, n in enumerate(sizes)]
    tw = [Request(prompt=list(range(n)), max_new_tokens=2,
                  arrival_t=float(i)) for i, n in enumerate(sizes)]
    jkv, tkv = JaxKV(3, 150), KVCacheManager(3, 150)
    js = JaxScheduler(admission=admission, token_budget=budget)
    ts = BatchScheduler(admission=admission, token_budget=budget)
    for _ in range(6):
        jp, tp = js.build_step(jw, jkv), ts.build_step(tw, tkv)
        assert [r.prompt for r in tp.rejected] == \
            [r.prompt for r in jp.rejected]
        assert [(g.bucket, g.slots, [len(r.prompt) for r in g.requests])
                for g in tp.prefills] == \
            [(g.bucket, g.slots, [len(r.prompt) for r in g.requests])
             for g in jp.prefills]
        assert tp.decode_slots == jp.decode_slots
        for slot in tkv.live_slots():
            n = int(rng.randint(1, 200))
            tkv.set_length(slot, n)
            jkv.set_length(slot, n)
        assert repr(tkv.occupancy()) == repr(jkv.occupancy())
        if tkv.live_slots():                 # one slot finishes per step
            s = tkv.live_slots()[0]
            tkv.free(s)
            jkv.free(s)


def test_more_requests_than_slots_and_run_returns_finished():
    cfg = get_smoke_config("qwen2-1.5b")
    eng = ServingEngine(cfg, num_slots=2, max_context=64, device="cpu")
    rng = np.random.RandomState(2)
    reqs = [Request(prompt=list(rng.randint(0, cfg.vocab_size, size=4)),
                    max_new_tokens=3) for _ in range(5)]
    for r in reqs:
        eng.submit(r)
    finished = eng.run()
    assert sorted(r.request_id for r in finished) == \
        sorted(r.request_id for r in reqs)
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert all(len(r.output) == 3 and r.ttft is not None for r in reqs)
    assert eng.stats.decode_tokens == 15
    assert eng.run() == []


def test_oversized_prompt_rejected():
    cfg = get_smoke_config("qwen2-1.5b")
    eng = ServingEngine(cfg, num_slots=1, max_context=16, device="cpu")
    r = Request(prompt=list(range(20)), max_new_tokens=2)
    eng.submit(r)
    eng.run()
    assert r.state == RequestState.REJECTED and r.error


def test_sampler_greedy_temperature_topk():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 5.0, 1.0], [3.0, 0.0, 0.0]])
    assert sample(gen, logits, torch.zeros(2)).tolist() == [1, 0]
    t1 = sample(gen, logits, torch.full((2,), 5.0))
    assert t1.shape == (2,) and bool(((t1 >= 0) & (t1 < 3)).all())
    # top-k=1 equals greedy at any temperature, shared or per slot
    assert sample(gen, logits, torch.full((2,), 5.0), 1).tolist() == [1, 0]
    per_slot = sample(gen, logits, torch.full((2,), 5.0),
                      torch.tensor([1, 1]))
    assert per_slot.tolist() == [1, 0]


def test_engine_without_device_needs_cuda():
    """No device means the card: without CUDA the engine refuses to start
    rather than silently running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(get_smoke_config("qwen2-1.5b"))
