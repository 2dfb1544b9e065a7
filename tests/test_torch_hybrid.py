"""Port parity: the hybrid (RecurrentGemma) serving path. Local attention
with its window, the ring cache's prefill roll and ring decode with a
per-slot index across the wrap, the recurrentgemma-9b smoke model's
prefill and teacher-forced decode logits, and the serving engine's greedy
tokens under exact-length grouping all match the JAX package (CPU, f32,
smoke size: window 64, every prompt and decode run below crosses it)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import ExecutionContext, build_model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.runtime import Request, ServingEngine  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _cfgs():
    jcfg, cfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    assert cfg.attention == jcfg.attention == "local"
    assert cfg.sliding_window == jcfg.sliding_window == 64
    return jcfg, cfg


# ---------------------------------------------------------------------------
# local attention and the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "decode_kernel"])
@pytest.mark.parametrize("S,budget", [(100, 128), (128, 256), (50, 128)])
def test_local_fullseq_and_prefill_cache_match_reference(impl, S, budget):
    """Windowed prefill attention, and the cache it fills: S=100 over a
    64-slot ring takes the roll (S % C = 36), S=128 fills it exactly,
    S=50 leaves it part empty."""
    jcfg, cfg = _cfgs()
    p = jax_attn.attention_init(jax.random.PRNGKey(1), jcfg)
    x = np.random.RandomState(0).randn(2, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    C = jax_attn.cache_capacity(jcfg, budget)
    assert attn.cache_capacity(cfg, budget) == C == min(budget, 64)
    yj, cj = jax_attn.attention_fullseq(
        p, jcfg, jnp.asarray(x), jnp.asarray(pos),
        jax_attn.init_kv_cache(jcfg, 2, C, jnp.float32), impl="xla")
    yt, ct = attn.attention_fullseq(
        _t(p), cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()),
        attn.init_kv_cache(cfg, 2, C, torch.float32), impl=impl)
    _close(yt, yj)
    for name in ("k", "v"):
        _close(ct[name], cj[name])
    assert int(ct["index"]) == int(cj["index"]) == S


@pytest.mark.parametrize("impl", ["xla", "decode_kernel"])
def test_ring_decode_per_slot_index_matches_reference(impl):
    """Four decode steps over a 64-slot ring from per-slot indices on both
    sides of the wrap (10, 62, 63, 64, 100, 191), with the ledger's
    lengths (index + 1, past C) handed to both: ring layers ignore them."""
    jcfg, cfg = _cfgs()
    rng = np.random.RandomState(2)
    p = jax_attn.attention_init(jax.random.PRNGKey(3), jcfg)
    index = np.array([10, 62, 63, 64, 100, 191], np.int32)
    B, C = len(index), 64
    shape = (B, C, cfg.num_kv_heads, cfg.head_dim)
    k0 = rng.randn(*shape).astype(np.float32)
    v0 = rng.randn(*shape).astype(np.float32)
    cj = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
          "index": jnp.asarray(index)}
    ct = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
          "index": torch.from_numpy(index.copy())}
    for step in range(4):
        x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        lens = index + step + 1
        yj, cj = jax_attn.attention_decode(p, jcfg, jnp.asarray(x), cj,
                                           impl=impl,
                                           lengths=jnp.asarray(lens))
        yt, ct = attn.attention_decode(_t(p), cfg, torch.from_numpy(x), ct,
                                       impl=impl,
                                       lengths=torch.from_numpy(lens))
        _close(yt, yj)
        for name in ("k", "v", "index"):
            _close(ct[name], cj[name])


def test_ring_decode_continues_prefill():
    """Prefill 70 tokens into a 64-slot ring (rolled), then decode 30 more
    one by one: every step equals the windowed prefill of the whole
    sequence at that position."""
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    p = attn.attention_init(gen, cfg)
    x = torch.randn(1, 100, cfg.d_model, generator=gen)
    pos = torch.arange(100, dtype=torch.int32)[None]
    full, _ = attn.attention_fullseq(p, cfg, x, pos)
    cache = attn.init_kv_cache(cfg, 1, 64, torch.float32)
    _, cache = attn.attention_fullseq(p, cfg, x[:, :70], pos[:, :70], cache)
    for t in range(70, 100):
        y, cache = attn.attention_decode(p, cfg, x[:, t:t + 1], cache)
        _close(y, full[:, t:t + 1].numpy())


# ---------------------------------------------------------------------------
# model and engine
# ---------------------------------------------------------------------------

def test_hybrid_layer_kinds_and_caches():
    _, cfg = _cfgs()
    model = build_model(cfg, dtype=torch.bfloat16, device="cpu")
    assert model.kinds == ("rec", "attn")
    caches = model.init_cache(3, 200)
    assert set(caches[0]) == {"h", "conv"}
    assert all(t.dtype == torch.float32 for t in caches[0].values())
    assert caches[0]["conv"].shape == (3, 3, cfg.recurrent.lru_width)
    assert caches[1]["k"].shape == (3, 64, 1, cfg.head_dim)
    assert caches[1]["k"].dtype == torch.bfloat16
    full = build_model(get_smoke_config(ARCH).reduced(num_layers=6),
                       device="cpu")
    assert full.kinds == ("rec", "attn") * 3


@pytest.fixture(scope="module")
def reference_run():
    """The reference model's parameters, and its logits and caches for a
    70-token prefill into a 64-slot ring (rolled) followed by 8
    teacher-forced decode steps."""
    jm = jax_build(jax_smoke(ARCH), dtype=jnp.float32)
    jparams = jm.init(jax.random.PRNGKey(0))
    toks = np.random.RandomState(0).randint(
        0, jm.cfg.vocab_size, size=(2, 78)).astype(np.int32)
    lj, cj = jm.prefill(jparams, jnp.asarray(toks[:, :70]), seq_budget=128)
    logits = [np.asarray(lj)]
    for t in range(70, 78):
        lj, cj = jm.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), cj)
        logits.append(np.asarray(lj))
    return jparams, toks, logits, jax.tree_util.tree_map(np.asarray, cj)


@pytest.mark.parametrize("impl", ["xla", "decode_kernel"])
def test_hybrid_model_logits_match_reference(impl, reference_run):
    """Prefill 70 tokens (a rolled ring), then 8 teacher-forced decode
    steps: logits against the reference's at every step and against the
    port's own prefill of the longer prompt; final caches."""
    jparams, toks, ref_logits, ref_caches = reference_run
    cfg = get_smoke_config(ARCH)
    tm = build_model(cfg, ctx=ExecutionContext(attn_impl=impl),
                     dtype=torch.float32, device="cpu")
    tparams = _t(jparams)
    lt, ct = tm.prefill(tparams, torch.from_numpy(toks[:, :70]).long(),
                        seq_budget=128)
    _close(lt, ref_logits[0], **MODEL_TOL)
    for j, t in enumerate(range(70, 78)):
        nxt = torch.from_numpy(toks[:, t:t + 1]).long()
        lt, ct = tm.decode_step(tparams, nxt, ct)
        _close(lt, ref_logits[j + 1], **MODEL_TOL)
        lp, _ = tm.prefill(tparams, torch.from_numpy(toks[:, :t + 1]).long(),
                           seq_budget=128)
        _close(lt, lp.numpy(), **MODEL_TOL)
    for c_t, c_j in zip(ct, ref_caches):
        for name in c_j:
            _close(c_t[name], c_j[name], **MODEL_TOL)


def _drive(eng, req_cls, prompts, max_new):
    """Submit the first request, step twice, then submit the rest: they
    land mid-flight in free slots (two share a length and prefill as one
    exact-length group)."""
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


def test_engine_tokens_match_reference(reference_run):
    """A 61-token prompt decodes across the 64-slot ring's wrap; the two
    90-token prompts prefill as one group and take the roll."""
    jparams = reference_run[0]
    jeng = JaxEngine(jax_smoke(ARCH), params=jparams, num_slots=2,
                     max_context=128, dtype=jnp.float32, plan_policy=None)
    cfg = get_smoke_config(ARCH)
    teng = ServingEngine(cfg, params=_t(jparams), num_slots=2,
                         max_context=128, dtype=torch.float32, device="cpu",
                         attn_impl="decode_kernel")
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(0, cfg.vocab_size, size=n))
               for n in (61, 90, 90)]
    max_new = [8, 4, 6]
    rj = _drive(jeng, JaxRequest, prompts, max_new)
    rt = _drive(teng, Request, prompts, max_new)
    for a, b in zip(rt, rj):
        assert a.output == b.output, (a.output, b.output)
        assert a.state.value == b.state.value
    assert teng.stats.prefill_tokens == jeng.stats.prefill_tokens
    assert teng.stats.decode_tokens == jeng.stats.decode_tokens


def test_engine_needs_cuda_without_device():
    """The entry point runs on the card unless the caller asks for the
    CPU: with no card it raises rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(get_smoke_config(ARCH))
