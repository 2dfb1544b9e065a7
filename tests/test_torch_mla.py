"""Port parity: MLA (DeepSeek-V2 latent attention) and the paper's two MoE
backbones. The port's MLA parameters and latent cache have the
reference's shapes; prefill attention and the cache it fills, and decode
with a per-slot index and the ledger's lengths (the latent ``ckv`` and
the RoPE'd ``kpe`` rows written in place, K/V recomputed from the whole
cache through ``w_ukv``), match the JAX package on both routes of each
side (f32, 1e-5); the flash route gets dense operands; paged KV refuses
MLA in both packages; the deepseek-v2-lite smoke model and a 16-expert
top-8 qwen3-moe variant serve the reference engine's greedy tokens on the
capacity path and on the DEP path (a gloo expert group of one rank
against a one-device plain ``Mesh``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import DepClusterConfig as JaxCluster  # noqa: E402
from repro.core.perf_model import PAPER_A6000 as JAX_A6000  # noqa: E402
from repro.core.planner import FinDEPPlanner as JaxPlanner  # noqa: E402
from repro.core.planner import PlannerConfig as JaxPlannerConfig  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro.sched import FinDEPPolicy as JaxPolicy  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import DepClusterConfig  # noqa: E402
from repro_torch.core.dep import DepGroups  # noqa: E402
from repro_torch.core.perf_model import PAPER_A6000  # noqa: E402
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.runtime import Request, ServingEngine  # noqa: E402
from repro_torch.sched import FinDEPPolicy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v2-lite"
#: the qwen3-moe smoke variant: top-8 of 16 experts, where the smoke
#: config keeps top-2 of 4
QWEN3_MOE = dict(num_experts=16, top_k=8)


def smoke_pair(arch):
    """(reference config, port config) at smoke size; qwen3-moe as the
    16-expert top-8 variant."""
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    if arch == "qwen3-moe":
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **QWEN3_MOE))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **QWEN3_MOE))
    return jcfg, cfg


def _t(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _cfgs():
    jcfg, cfg = smoke_pair(ARCH)
    assert cfg.attention == jcfg.attention == "mla"
    assert cfg.mla_kv_lora_rank == jcfg.mla_kv_lora_rank == 64
    return jcfg, cfg


def test_mla_parameters_and_cache_have_reference_shapes():
    """wq, w_dkv, w_ukv, w_kpe, wo with the reference's shapes and bias
    rule; the latent cache {ckv [B,C,r], kpe [B,C,hd], index}."""
    jcfg, cfg = _cfgs()
    jp = jax.tree_util.tree_map(np.shape, jax_attn.attention_init(
        jax.random.PRNGKey(0), jcfg))
    tp = jax.tree_util.tree_map(
        lambda t: tuple(t.shape),
        attn.attention_init(torch.Generator().manual_seed(0), cfg))
    assert tp == jp
    assert set(tp) == {"wq", "w_dkv", "w_ukv", "w_kpe", "wo"}
    jc = jax_attn.init_kv_cache(jcfg, 3, 32, jnp.float32)
    tc = attn.init_kv_cache(cfg, 3, 32, torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert tuple(tc["ckv"].shape) == (3, 32, 64)
    assert attn.cache_len(tc) == 32


@pytest.mark.parametrize("impl", ["xla", "flash", "decode_kernel"])
def test_mla_fullseq_and_prefill_cache_match_reference(impl):
    """Prefill attention over 20 positions and the latent cache it fills
    (C = 32) against the reference's, which runs ``_sdpa`` under every
    impl; the port's "flash" and "decode_kernel" take the flash route."""
    jcfg, cfg = _cfgs()
    p = jax_attn.attention_init(jax.random.PRNGKey(1), jcfg)
    S = 20
    x = np.random.RandomState(0).randn(2, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    yj, cj = jax_attn.attention_fullseq(
        p, jcfg, jnp.asarray(x), jnp.asarray(pos),
        jax_attn.init_kv_cache(jcfg, 2, 32, jnp.float32),
        impl="flash" if impl == "flash" else "xla")
    yt, ct = attn.attention_fullseq(
        _t(p), cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()),
        attn.init_kv_cache(cfg, 2, 32, torch.float32), impl=impl)
    _close(yt, yj)
    assert set(ct) == set(cj) == {"ckv", "kpe", "index"}
    for name in ("ckv", "kpe"):
        _close(ct[name], cj[name])
    assert int(ct["index"]) == int(cj["index"]) == S


def test_mla_flash_route_gets_dense_operands(monkeypatch):
    """The flash kernel reads dense rows (TMA), and MLA's v is a strided
    view of the up-projection: the route hands the kernel contiguous q,
    k, v of MHA shape (Kv == H)."""
    _, cfg = _cfgs()
    seen = []
    ref = flash_ops.flash_attention

    def record(q, k, v, **kw):
        seen.append((q, k, v))
        return ref(q, k, v, **kw)

    monkeypatch.setattr(flash_ops, "flash_attention", record)
    p = attn.attention_init(torch.Generator().manual_seed(2), cfg)
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator())
    pos = torch.arange(9, dtype=torch.int32)[None].expand(2, 9)
    attn.attention_fullseq(p, cfg, x, pos, impl="flash")
    (q, k, v), = seen
    H, hd = cfg.num_heads, cfg.head_dim
    assert q.shape == k.shape == v.shape == (2, 9, H, hd)
    assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()


@pytest.mark.parametrize("impl", ["xla", "decode_kernel"])
def test_mla_decode_per_slot_index_matches_reference(impl):
    """Prefill three rows of 16 positions into a 32-slot latent cache,
    then five decode steps from per-slot indices (5, 16, 9) with the
    ledger's lengths: outputs, ``ckv``/``kpe`` and the index equal the
    reference's after the prefill and after every step, and the port
    writes each row into the cache tensors it was given."""
    jcfg, cfg = _cfgs()
    rng = np.random.RandomState(3)
    p = jax_attn.attention_init(jax.random.PRNGKey(4), jcfg)
    tp = _t(p)
    B, S = 3, 16
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    _, cj = jax_attn.attention_fullseq(
        p, jcfg, jnp.asarray(x), jnp.asarray(pos),
        jax_attn.init_kv_cache(jcfg, B, 32, jnp.float32))
    _, ct = attn.attention_fullseq(
        tp, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()),
        attn.init_kv_cache(cfg, B, 32, torch.float32), impl=impl)
    for name in ("ckv", "kpe"):
        _close(ct[name], cj[name])
    index = np.array([5, 16, 9], np.int32)
    cj = dict(cj, index=jnp.asarray(index))
    ct["index"] = torch.from_numpy(index.copy())
    ptrs = {name: ct[name].data_ptr() for name in ("ckv", "kpe")}
    for step in range(5):
        xs = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        lens = index + step + 1
        yj, cj = jax_attn.attention_decode(p, jcfg, jnp.asarray(xs), cj,
                                           impl=impl,
                                           lengths=jnp.asarray(lens))
        yt, ct = attn.attention_decode(tp, cfg, torch.from_numpy(xs), ct,
                                       impl=impl,
                                       lengths=torch.from_numpy(lens))
        _close(yt, yj)
        for name in ("ckv", "kpe", "index"):
            _close(ct[name], cj[name])
        assert {n: ct[n].data_ptr() for n in ptrs} == ptrs


def test_paged_kv_refuses_mla_in_both_packages():
    """Paged KV has no latent layout: both engines refuse it at
    construction, and the port's paged decode raises on an MLA config."""
    jcfg, cfg = _cfgs()
    with pytest.raises(ValueError, match="mla=64"):
        JaxEngine(jcfg, num_slots=2, max_context=32, kv_layout="paged")
    with pytest.raises(ValueError, match="mla=64"):
        ServingEngine(cfg, num_slots=2, max_context=32, kv_layout="paged",
                      dtype=torch.float32, device="cpu")
    p = attn.attention_init(torch.Generator().manual_seed(0), cfg)
    table = torch.zeros((2, 2), dtype=torch.int32)
    paged = attn.paged_address(table, torch.zeros(2, dtype=torch.int32), 16)
    with pytest.raises(NotImplementedError, match="mla=64"):
        attn.attention_decode(p, cfg, torch.zeros(2, 1, cfg.d_model),
                              attn.init_kv_cache(cfg, 2, 32, torch.float32),
                              paged=paged)


# ---------------------------------------------------------------------------
# the engine: capacity and DEP
# ---------------------------------------------------------------------------

#: (prompt length, new tokens): one prefill bucket; the slots finish one
#: by one, so the decode occupancy (and under DEP its plan) changes
REQS = ((5, 5), (7, 3), (3, 4))


@pytest.fixture(scope="module")
def group():
    """A gloo expert group of one rank (the default process group of this
    process, over an in-process store)."""
    groups = DepGroups.single("gloo")
    yield groups
    torch.distributed.destroy_process_group()


def _serve(eng, req_cls, vocab):
    rng = np.random.RandomState(1)
    reqs = [req_cls(prompt=rng.randint(1, vocab, size=n).tolist(),
                    max_new_tokens=m) for n, m in REQS]
    for r in reqs:
        eng.submit(r)
    assert len(eng.run()) == len(reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("dep", [False, True], ids=["capacity", "dep"])
@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe"])
def test_engine_tokens_match_reference(arch, dep, request):
    """The port's engine serves the reference engine's greedy tokens on
    the same weights: the capacity path against the reference without a
    mesh, and with a FinDEP policy on a gloo expert group of one rank
    (every MoE layer walks its call's program) against the reference on
    a one-device mesh."""
    jcfg, cfg = smoke_pair(arch)
    kw, jkw = {}, {}
    if dep:
        kw = dict(ep_group=request.getfixturevalue("group"),
                  plan_policy=FinDEPPolicy(FinDEPPlanner(
                      cfg, DepClusterConfig(8, 3, 5), PAPER_A6000,
                      PlannerConfig(mem_cap_samples=8))))
        jkw = dict(mesh=jax.sharding.Mesh(
            np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")),
            plan_policy=JaxPolicy(JaxPlanner(
                jcfg, JaxCluster(8, 3, 5), JAX_A6000,
                JaxPlannerConfig(mem_cap_samples=8))))
    jeng = JaxEngine(jcfg, num_slots=3, max_context=64, seed=0,
                     dtype=jnp.float32, **jkw)
    teng = ServingEngine(cfg, params=_t(jeng.params), num_slots=3,
                         max_context=64, dtype=torch.float32, device="cpu",
                         seed=0, **kw)
    assert teng.model.ctx.moe_impl == ("dep" if dep else "capacity")
    assert _serve(teng, Request, cfg.vocab_size) == \
        _serve(jeng, JaxRequest, cfg.vocab_size)
    if dep:
        phases = [ph for ph, _ in teng.stats.programs]
        assert phases.count("decode") == teng.stats.steps > 0
