"""Port parity: paged KV with prefix sharing and preemption. The port's
ledger (``BlockPool``, ``PrefixCache``, ``PagedKVCacheManager``) gives the
reference's counters on the same traces; the paged kernel's plain version
matches the reference's Pallas kernel (interpret mode) and oracle; the
paged decode step gives the reference's logits; and the port's paged
engine gives the reference's paged engine's greedy tokens and paging
counters, preemption included (CPU, f32, smoke size)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.kernels.decode_attention.kernel import \
    paged_decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref  # noqa: E402
from repro.models import ExecutionContext as JaxCtx  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.runtime import PagedKVCacheManager as JaxPagedKV  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro.runtime import chunk_keys as jax_chunk_keys  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels.decode_attention.ops import \
    decode_attention_paged  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, gather_pages, paged_decode_attention_ref)
from repro_torch.models import ExecutionContext, build_model  # noqa: E402
from repro_torch.runtime import (Request, RequestState,  # noqa: E402
                                 ServingEngine)
from repro_torch.runtime.paging import (BlockPool,  # noqa: E402
                                        PagedKVCacheManager, chunk_keys)

BS = 16


@pytest.fixture(autouse=True)
def _check_ledger_invariants(monkeypatch):
    """Every port pool/manager a test constructs (engines' included) is
    invariant-checked at teardown, as the reference's paging tests do."""
    pools, managers = [], []
    orig_pool, orig_mgr = BlockPool.__init__, PagedKVCacheManager.__init__

    def pool_init(self, *a, **kw):
        orig_pool(self, *a, **kw)
        pools.append(self)

    def mgr_init(self, *a, **kw):
        orig_mgr(self, *a, **kw)
        managers.append(self)

    monkeypatch.setattr(BlockPool, "__init__", pool_init)
    monkeypatch.setattr(PagedKVCacheManager, "__init__", mgr_init)
    yield
    owned = {id(kv.pool) for kv in managers}
    for kv in managers:
        kv.check_invariants()
    for pool in pools:
        if id(pool) not in owned:
            pool.check_invariants()


# ---------------------------------------------------------------------------
# ledger parity (model=None managers)
# ---------------------------------------------------------------------------

def _capacity_trace(kv, shared_tokens=256, user_tokens=32, gen_tokens=96):
    """The shared-system-prompt trace of ``benchmarks/paged_kv.py``: admit
    and fully decode conversations until the pool refuses one."""
    shared = list(range(shared_tokens))
    admitted = conv = 0
    while True:
        prompt = shared + [10_000 + conv * 131 + i
                           for i in range(user_tokens)]
        conv += 1
        slot = kv.alloc()
        if slot is None:
            break
        Lp = len(prompt) - 1
        try:
            kv.assign_blocks(slot, prompt[:Lp])
        except RuntimeError:
            kv.free(slot)
            break
        kv.set_length(slot, Lp + 1)
        ok = True
        for _ in range(gen_tokens):
            if not kv.ensure_decode_page(slot):
                ok = False
                break
            kv.set_length(slot, kv.length(slot) + 1)
        if not ok:
            kv.free(slot)
            break
        admitted += 1
    return admitted


def _both(*args, **kw):
    return PagedKVCacheManager(*args, **kw), JaxPagedKV(*args, **kw)


def test_capacity_trace_summary_matches_reference():
    port, ref = _both(256, 4096, block_size=32, num_blocks=8192 // 32 + 1)
    assert _capacity_trace(port) == _capacity_trace(ref)
    assert port.paging_summary() == ref.paging_summary()
    assert port.paging_summary()["prefix_hit_rate"] > 0
    assert repr(port.occupancy()) == repr(ref.occupancy())
    assert port.occupancy().block_pressure == ref.occupancy().block_pressure


def test_chunk_keys_match_reference():
    toks = list(np.random.RandomState(0).randint(0, 1000, size=70))
    assert chunk_keys(toks, BS) == jax_chunk_keys(toks, BS)
    assert len(chunk_keys(toks, BS)) == 70 // BS


def test_admission_charge_matches_reference():
    for kv in _both(2, 128, block_size=BS):
        prompt = list(range(2 * BS + 5))
        assert kv.admission_charge(prompt) == (3, 0)
        s = kv.alloc()
        kv.assign_blocks(s, prompt)
        assert kv.admission_charge(prompt) == (1, 2 * BS)
        assert kv.cached_prefix_tokens(prompt) == 2 * BS
    port, ref = _both(2, 128, block_size=BS)
    for kv in (port, ref):
        kv.assign_blocks(kv.alloc(), list(range(3 * BS)))
    assert port.paging_summary() == ref.paging_summary()


def test_watermark_hysteresis_matches_reference():
    seen = []
    for kv in _both(4, 128, block_size=BS, num_blocks=11,
                    watermark_high=0.6, watermark_low=0.3):
        s = kv.alloc()
        kv._assign_private(s, 6 * BS)           # 7 of 10 usable pages
        trace = [kv.admission_blocked()]
        kv.free(s)
        s2 = kv.alloc()
        kv._assign_private(s2, 3 * BS)          # between low and high
        trace.append(kv.admission_blocked())
        kv.free(s2)
        trace.append(kv.admission_blocked())    # below low: re-opened
        seen.append((trace, kv.paging_summary()))
    assert seen[0] == seen[1]
    assert seen[0][0] == [True, True, False]


def test_exhaustion_rolls_back_like_reference():
    out = []
    for kv in _both(2, 128, block_size=BS, num_blocks=3):
        s = kv.alloc()
        with pytest.raises(RuntimeError):
            kv.assign_blocks(s, list(range(5 * BS)))
        assert kv._nblk[s] == 0
        assert kv.pool.free_count() == 2
        # the full blocks registered before the failure were unmapped
        assert kv.cached_prefix_tokens(list(range(5 * BS))) == 0
        out.append(kv.paging_summary())
    assert out[0] == out[1]


def test_eviction_readmission_and_shared_frees_match_reference():
    out = []
    for kv in _both(4, 128, block_size=BS, num_blocks=17):
        rng = np.random.RandomState(9)
        prompts = [rng.randint(0, 100, size=n).tolist()
                   for n in (40, 25, 50)]
        for _ in range(3):
            slots = []
            for p in prompts:
                s = kv.alloc()
                kv.assign_blocks(s, p)
                kv.set_length(s, len(p) + 1)
                slots.append(s)
            for s in slots:
                kv.ensure_decode_page(s)
                kv.free(s)
            assert kv.pool.used_count() == kv.prefix.reclaimable_count()
        out.append(kv.paging_summary())
    assert out[0] == out[1]
    assert out[0]["prefix_hit_blocks"] == 2 * sum(n // BS
                                                  for n in (40, 25, 50))
    # three holders of one shared page free in arbitrary order: parked
    # exactly once, at the last release
    kv = PagedKVCacheManager(4, 64, block_size=BS)
    slots = [kv.alloc() for _ in range(3)]
    for s in slots:
        kv.assign_blocks(s, list(range(BS)))
    page = int(kv._tables[slots[0], 0])
    for n_left, s in zip((2, 1, 0), (slots[1], slots[0], slots[2])):
        kv.free(s)
        assert kv.pool.ref(page) == n_left
    assert kv.prefix.reclaimable_count() == 1


def test_block_pool_lifecycle():
    pool = BlockPool(6, BS)
    pages = [pool.alloc() for _ in range(5)]
    assert pages == [1, 2, 3, 4, 5] and pool.alloc() is None
    pool.retain(pages[0])
    assert pool.release(pages[0]) == 1
    for p in pages:
        assert pool.release(p) == 0
        pool.free(p)
    assert pool.free_count() == 5 and pool.frees == 5
    with pytest.raises(AssertionError):
        pool.free(0)                           # the scratch page


# ---------------------------------------------------------------------------
# kernel: the paged plain version
# ---------------------------------------------------------------------------

def _paged_case(lengths, bs, Kv, g, D=32, n_extra=3, seed=3):
    """A dense ragged cache and the same contents in SHUFFLED pages."""
    B, H = len(lengths), Kv * g
    nmax = max(max(-(-n // bs) for n in lengths), 1)
    C = nmax * bs
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, C, Kv, D).astype(np.float32)
    v = rng.randn(B, C, Kv, D).astype(np.float32)
    P = 1 + sum(-(-n // bs) for n in lengths) + n_extra
    order = rng.permutation(np.arange(1, P)).tolist()
    kp = np.zeros((P, bs, Kv, D), np.float32)
    vp = np.zeros((P, bs, Kv, D), np.float32)
    tbl = np.full((B, nmax), -1, np.int32)
    for b, n in enumerate(lengths):
        for c in range(-(-n // bs)):
            page = order.pop()
            tbl[b, c] = page
            kp[page] = k[b, c * bs:(c + 1) * bs]
            vp[page] = v[b, c * bs:(c + 1) * bs]
    return q, k, v, kp, vp, np.asarray(lengths, np.int32), tbl


@pytest.mark.parametrize("bs,Kv,g,lengths", [
    (16, 2, 2, [0, 1, 17, 48, 57]),
    (32, 2, 3, [0, 1, 96, 33]),                # len C, g=3
    (16, 1, 6, [80, 0, 5]),                    # g=6 over one KV head
])
def test_paged_plain_matches_pallas_and_oracle(bs, Kv, g, lengths):
    q, k, v, kp, vp, lens, tbl = _paged_case(lengths, bs, Kv, g)
    tq, tkp, tvp, tlens, ttbl = (torch.from_numpy(a)
                                 for a in (q, kp, vp, lens, tbl))
    port = decode_attention_paged(tq, tkp, tvp, tlens, ttbl)
    pallas = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(tbl), interpret=True)
    oracle = jax_paged_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(lens), jnp.asarray(tbl))
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.numpy(), np.asarray(oracle),
                               rtol=1e-5, atol=1e-5)
    assert not port[torch.from_numpy(lens == 0)].any()   # exact zeros
    # the paged plain version is the dense one over the gathered pages
    dense = decode_attention_ref(tq, torch.from_numpy(k),
                                 torch.from_numpy(v), tlens)
    assert torch.equal(port, dense)
    assert torch.equal(gather_pages(tkp, ttbl)[0, :lengths[0]],
                       torch.from_numpy(k)[0, :lengths[0]])


def test_paged_wrapper_dispatch_by_device():
    """A CPU call runs the plain version and counts no launch; a ``meta``
    operand takes the shapes-only branch: an empty ``meta`` output of the
    plain version's shape and dtype, no launch counted and no aten op
    dispatched (no fallback to the plain version)."""
    from repro_torch.roofline import StepCounter
    tk.reset_launch_counts()
    q, _, _, kp, vp, lens, tbl = _paged_case([5, 0], 16, 2, 2)
    out = paged_decode_attention_ref(*(torch.from_numpy(a) for a in
                                       (q, kp, vp, lens, tbl)))
    got = decode_attention_paged(*(torch.from_numpy(a) for a in
                                   (q, kp, vp, lens, tbl)))
    assert torch.equal(got, out)
    assert tk.launch_counts()["decode_attention_paged"] == 0
    meta = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                        device="meta") for a in (q, kp, vp, lens, tbl)]
    with StepCounter() as c:
        shell = decode_attention_paged(*meta)
    assert shell.device.type == "meta"
    assert (shell.shape, shell.dtype) == (got.shape, got.dtype)
    assert c.counts.aten_ops == 0
    assert c.counts.kernels["decode_attention_paged"]["calls"] == 1
    assert tk.launch_counts()["decode_attention_paged"] == 0


# ---------------------------------------------------------------------------
# model: decode through block tables
# ---------------------------------------------------------------------------

def test_paged_decode_step_logits_match_reference():
    """Prefill two rows sharing a first block, merge them into paged
    caches on both sides (the prefix hit skips the copy), then decode two
    steps through the block tables; row 0's second write opens a new
    page."""
    arch = "qwen2-moe-a2.7b"
    jm = jax_build(jax_smoke(arch), ctx=JaxCtx(attn_impl="decode_kernel"),
                   dtype=jnp.float32)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    tm = build_model(cfg, ctx=ExecutionContext(attn_impl="decode_kernel"),
                     dtype=torch.float32, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.RandomState(5)
    toks = rng.randint(1, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    toks[1, :BS] = toks[0, :BS]
    lens = [31, 33]
    jkv = JaxPagedKV(3, 64, jm, dtype=jnp.float32, block_size=BS)
    tkv = PagedKVCacheManager(3, 64, tm, dtype=torch.float32, block_size=BS)
    last = np.asarray(lens) - 1
    lj, pj = jm.prefill(jparams, jnp.asarray(toks), seq_budget=64,
                        last_positions=jnp.asarray(last))
    lt, pt = tm.prefill(tparams, torch.from_numpy(toks).long(),
                        seq_budget=64, last_positions=torch.from_numpy(last))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    rows = [toks[0, :31].tolist(), toks[1, :33].tolist()]
    for kv, pre in ((jkv, pj), (tkv, pt)):
        kv.take(0)
        kv.take(1)
        kv.merge_prefill([0, 1], pre, lens, tokens=rows)
    assert tkv.paging_summary() == jkv.paging_summary()
    assert tkv.paging.prefix_hit_tokens == BS
    cj, ct = jkv.caches, tkv.caches
    nxt = np.asarray(jnp.argmax(lj[:, -1], -1))
    for _ in range(2):
        for kv in (jkv, tkv):
            for s in (0, 1):
                assert kv.ensure_decode_page(s)
        assert np.array_equal(tkv.table_array().numpy(),
                              np.asarray(jkv.table_array()))
        lengths = np.asarray([jkv.length(0), jkv.length(1), 0], np.int32)
        tok = np.asarray([nxt[0], nxt[1], 0], np.int32)[:, None]
        lj, cj = jm.decode_step(jparams, jnp.asarray(tok), cj,
                                lengths=jnp.asarray(lengths),
                                block_tables=jkv.table_array())
        lt, ct = tm.decode_step(tparams, torch.from_numpy(tok).long(), ct,
                                lengths=torch.from_numpy(lengths),
                                block_tables=tkv.table_array())
        np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2],
                                   rtol=1e-4, atol=1e-4)
        nxt = np.asarray(jnp.argmax(lj[:, -1], -1))
        assert np.array_equal(lt[:2, -1].argmax(-1).numpy(), nxt[:2])
        for kv in (jkv, tkv):
            kv.note_decode([0, 1])
    assert np.array_equal(ct[0]["index"].numpy(), np.asarray(cj[0]["index"]))
    assert tkv._nblk[:2] == jkv._nblk[:2] == [3, 3]


# ---------------------------------------------------------------------------
# engine: the port's paged engine against the reference's
# ---------------------------------------------------------------------------

def _smoke_kw():
    return dict(name="paging-smoke", family="dense", num_layers=2,
                d_model=64, num_heads=4, num_kv_heads=2, ffn_dim=128,
                vocab_size=128, head_dim=16)


def _requests(req_cls):
    rng = np.random.RandomState(7)
    shared = rng.randint(1, 128, size=40).tolist()
    out = []
    for seed, n in ((1, 5), (2, 12), (3, 3), (4, 21)):
        tail = np.random.RandomState(seed).randint(1, 128, size=n).tolist()
        out.append(req_cls(prompt=shared + tail, max_new_tokens=6))
    return out


def _engines(**kw):
    common = dict(num_slots=4, max_context=128, kv_layout="paged",
                  kv_block_size=BS, **kw)
    jeng = JaxEngine(JaxConfig(**_smoke_kw()), dtype=jnp.float32, seed=0,
                     plan_policy=None, **common)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jeng.params))
    teng = ServingEngine(ModelConfig(**_smoke_kw()), params=params,
                         dtype=torch.float32, device="cpu", **common)
    return jeng, teng, params


def test_paged_engine_matches_reference_and_dense():
    jeng, teng, params = _engines()
    deng = ServingEngine(ModelConfig(**_smoke_kw()), params=params,
                         num_slots=4, max_context=128, dtype=torch.float32,
                         device="cpu")
    outs = []
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request),
                         (deng, Request)):
        for r in _requests(req_cls):
            eng.submit(r)
        outs.append({len(r.prompt): r.output for r in eng.run()})
    assert outs[0] == outs[1] == outs[2]
    assert teng.paging_stats() == jeng.paging_stats()
    assert teng.paging_stats()["prefix_hit_tokens"] > 0
    assert teng.paging_stats()["preemptions"] == 0
    assert deng.paging_stats() is None


def _decode_step_ops(layout, num_layers, monkeypatch):
    """Tensor ops one engine decode step dispatches (views excluded), with
    both decode-attention wrappers counted as one op each: what stays is
    the step's own work around the kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels.decode_attention import ops as dec_ops
    for name in ("decode_attention", "decode_attention_paged"):
        monkeypatch.setattr(dec_ops, name, lambda q, *a: torch.zeros_like(q))
    views = {"view", "_unsafe_view", "expand", "slice", "select", "t",
             "unsqueeze", "alias", "as_strided", "detach", "squeeze",
             "permute", "transpose", "reshape", "lift_fresh", "unbind"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in views:
                self.n += 1
            return func(*args, **(kwargs or {}))

    eng = ServingEngine(ModelConfig(**dict(_smoke_kw(),
                                           num_layers=num_layers)),
                        num_slots=4, max_context=128, kv_layout=layout,
                        kv_block_size=BS, dtype=torch.float32, device="cpu")
    for r in _requests(Request):
        eng.submit(r)
    eng.step()
    lengths = torch.as_tensor(eng.kv.lengths(), dtype=torch.int32)
    with Count() as count:
        eng._decode_step(lengths, use_topk=False)
    return count.n


def test_paged_decode_step_addresses_pages_once_per_step(monkeypatch):
    """The page arithmetic (table gather, page and row of the new token,
    clamped lengths) is worked out once per decode step, not per layer:
    each further layer costs the paged step no more ops than the dense
    one."""
    per_layer = {}
    for layout in ("dense", "paged"):
        n2, n4 = (_decode_step_ops(layout, L, monkeypatch) for L in (2, 4))
        per_layer[layout] = (n4 - n2) / 2
    assert per_layer["paged"] <= per_layer["dense"], per_layer


def test_preemption_matches_reference():
    """A pool so small that concurrent generations must preempt: every
    request finishes with its full output on both sides, with the same
    tokens and the same paging counters."""
    jeng, teng, _ = _engines(kv_num_blocks=9)
    outs = []
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request)):
        rng = np.random.RandomState(11)
        reqs = [req_cls(prompt=rng.randint(1, 128, size=30).tolist(),
                        max_new_tokens=40) for _ in range(3)]
        for r in reqs:
            eng.submit(r)
        fin = eng.run(max_steps=500)
        assert len(fin) == 3
        assert all(r.state.value == "finished" and len(r.output) == 40
                   for r in fin)
        outs.append(([r.output for r in reqs],
                     [r.preemptions for r in reqs]))
    assert outs[0] == outs[1]
    ps = teng.paging_stats()
    assert ps == jeng.paging_stats()
    assert ps["preemptions"] >= 1
    assert ps["blocks_used"] == ps["blocks_reclaimable"]


def test_paged_guards():
    eng = ServingEngine(ModelConfig(**_smoke_kw()), num_slots=2,
                        max_context=128, kv_layout="paged", kv_block_size=BS,
                        kv_num_blocks=4, dtype=torch.float32, device="cpu")
    eng.submit(Request(prompt=list(range(1, 100)), max_new_tokens=2))
    fin = eng.run(max_steps=5)
    assert len(fin) == 1 and fin[0].state is RequestState.REJECTED
    assert "pages" in fin[0].error
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(get_smoke_config("xlstm-1.3b"), kv_layout="paged",
                      device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(ModelConfig(**dict(_smoke_kw(), attention="sliding")),
                      kv_layout="paged", device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        ServingEngine(ModelConfig(**_smoke_kw()), kv_layout="ring",
                      device="cpu")
