"""The engine's decode step as the CUDA graph captures it
(``repro_torch.runtime.decode_graph``), held on the CPU, where no graph
runs: the step over static buffers equals ``Model.decode_step`` followed
by rebinding, bitwise, on every family, and ends each step in the KV
manager's own tensors; a paged engine that preempts gives the functional
engine's and the JAX engine's greedy tokens; the ``decode_graph`` option;
and the launch accounting of replays, through a stand-in for
``CUDAGraph`` (f32, smoke size)."""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import Request as JaxRequest  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.runtime import Request, ServingEngine, sample  # noqa: E402
from repro_torch.runtime.decode_graph import (DecodeGraphs,  # noqa: E402
                                              GraphKey)
from test_torch_paging import BS, _engines, _smoke_kw  # noqa: E402

#: prompt lengths per family: pages of 16 hold the 45-token prompt's
#: positions up to 47, so its fifth decode write opens a page; the hybrid
#: smoke window is 64, so the slots of 62 and 61 wrap their rings within
#: six steps
PROMPTS = {"dense": (5, 20, 45), "moe": (5, 20, 45), "ssm": (7, 16, 3),
           "hybrid": (62, 30, 61)}

CASES = [("qwen2-moe-a2.7b", "dense"), ("qwen2-moe-a2.7b", "paged"),
         ("qwen2-1.5b", "dense"), ("qwen2-1.5b", "paged"),
         ("xlstm-1.3b", "dense"), ("recurrentgemma-9b", "dense"),
         ("deepseek-v2-lite", "dense"), ("qwen3-moe", "dense")]


def _engine(cfg, layout="dense", **kw):
    return ServingEngine(cfg, num_slots=3, max_context=128,
                         kv_layout=layout, kv_block_size=BS,
                         dtype=torch.float32, device="cpu", seed=0, **kw)


def _requests(cfg, max_new=(8, 8, 8), temps=(0.0, 0.0, 0.0),
              top_ks=(0, 0, 0)):
    rng = np.random.RandomState(4)
    return [Request(prompt=rng.randint(1, cfg.vocab_size, size=n).tolist(),
                    max_new_tokens=m, temperature=t, top_k=k)
            for n, m, t, k in zip(PROMPTS[cfg.family], max_new, temps,
                                  top_ks)]


def _ptrs(caches):
    return [{name: t.data_ptr() for name, t in c.items()} for c in caches]


@pytest.mark.parametrize("arch,layout", CASES,
                         ids=[f"{a}-{l}" for a, l in CASES])
def test_static_step_equals_functional_step(arch, layout):
    """Six decode steps of the engine's step (static buffers, states
    committed in place) beside ``Model.decode_step`` + rebinding on a copy
    of the same prefilled caches: logits, tokens and every cache tensor
    bitwise equal at every step, and every cache tensor of the engine
    keeps its address. The mLSTM matrix state comes back as the tensor
    it came in as (written in place, never copied back)."""
    cfg = get_smoke_config(arch)
    eng = _engine(cfg, layout)
    for r in _requests(cfg):
        eng.submit(r)
    eng._admit()
    live = [s for s, r in enumerate(eng.slots) if r is not None]
    assert len(live) == 3
    functional = [{name: t.clone() for name, t in c.items()}
                  for c in eng.kv.caches]
    tokens = eng.last_tokens.clone()
    ptrs = _ptrs(eng.kv.caches)
    table_changes = 0
    for _ in range(6):
        if layout == "paged":
            before = eng.kv._tables.copy()
            live = eng._ensure_decode_capacity(live)
            table_changes += not np.array_equal(before, eng.kv._tables)
        lengths = eng.kv.lengths()
        nxt = eng._decode_step(lengths, use_topk=False)
        table = eng.kv.table_array().clone() if layout == "paged" else None
        prev = functional
        logits, functional = eng.model.decode_step(
            eng.params, tokens, functional,
            lengths=torch.tensor(lengths, dtype=torch.int32),
            block_tables=table)
        tokens = sample(torch.Generator(), logits[:, -1],
                        torch.zeros(3), 0)[:, None]
        assert torch.equal(eng.last_logits, logits)
        assert torch.equal(nxt, tokens[:, 0])
        assert torch.equal(eng.last_tokens, tokens)
        for kind, c_old, c_new in zip(eng.model.kinds, prev, functional):
            if kind == "mlstm":
                assert c_new["C"] is c_old["C"]
        for c_static, c_func in zip(eng.kv.caches, functional):
            assert set(c_static) == set(c_func)
            for name in c_static:
                assert torch.equal(c_static[name], c_func[name]), name
        eng.kv.note_decode(live)
    assert _ptrs(eng.kv.caches) == ptrs
    if layout == "paged":
        assert table_changes >= 1
    if cfg.family == "hybrid":
        ring = next(c for c in eng.kv.caches if "index" in c)
        assert int(ring["index"].max()) > ring["k"].shape[1]   # wrapped
    if cfg.family == "ssm":
        assert set(eng.model.kinds) == {"mlstm", "slstm"}


class _FunctionalEngine(ServingEngine):
    """The engine's decode step as it was before the static buffers: new
    lengths and table tensors every step, and the new caches and tokens
    rebound after it."""

    def _decode_step(self, lengths, use_topk, program=None, cap_scale=1.0):
        table = (torch.from_numpy(self.kv._tables.copy()) if self._paged
                 else None)
        logits, caches = self.model.decode_step(
            self.params, self.last_tokens, self.kv.caches,
            lengths=torch.as_tensor(lengths, dtype=torch.int32),
            block_tables=table)
        nxt = sample(self.generator, logits[:, -1], self.temps,
                     self.top_ks if use_topk else 0)
        self.kv.caches = caches
        self.last_tokens = nxt[:, None]
        return nxt


def test_static_buffers_follow_preemption():
    """A pool of 9 pages that must preempt: the engine's step, fed the
    lengths and changed tables through its static buffers, gives the
    tokens, preemptions and paging counters of the functional step and of
    the JAX engine."""
    jeng, teng, params = _engines(kv_num_blocks=9)
    feng = _FunctionalEngine(ModelConfig(**_smoke_kw()), params=params,
                             num_slots=4, max_context=128,
                             kv_layout="paged", kv_block_size=BS,
                             kv_num_blocks=9, dtype=torch.float32,
                             device="cpu")
    outs = []
    for eng, req_cls in ((jeng, JaxRequest), (teng, Request),
                         (feng, Request)):
        rng = np.random.RandomState(11)
        reqs = [req_cls(prompt=rng.randint(1, 128, size=30).tolist(),
                        max_new_tokens=40) for _ in range(3)]
        for r in reqs:
            eng.submit(r)
        assert len(eng.run(max_steps=500)) == 3
        outs.append(([r.output for r in reqs],
                     [r.preemptions for r in reqs], eng.paging_stats()))
    assert outs[0] == outs[1] == outs[2]
    assert outs[1][2]["preemptions"] >= 1


def test_decode_graph_option():
    """``decode_graph=True`` on the CPU raises; the default there runs the
    step eagerly, with no capture and no replay."""
    cfg = get_smoke_config("qwen2-1.5b")
    with pytest.raises(ValueError, match="decode_graph=True needs a CUDA"):
        _engine(cfg, decode_graph=True)
    eng = _engine(cfg)
    assert eng.decode_graph is False and eng._graphs is None
    for r in _requests(cfg, max_new=(3, 3, 3)):
        eng.submit(r)
    assert len(eng.run()) == 3
    assert eng.stats.steps > 0
    assert (eng.stats.graph_captures, eng.stats.graph_replays) == (0, 0)


def _counting(fn):
    """``fn`` with a launch count of its own that its CPU calls bump, as
    the kernel wrappers' CUDA calls do."""
    def wrapper(*args, **kwargs):
        wrapper.launches += 1
        return fn(*args, **kwargs)
    wrapper.launches = 0
    return wrapper


class _EagerGraph:
    """Stands in for ``CudaGraph`` on the CPU. Its capture runs the step
    (a real capture only records it, and the replay after it runs it), so
    the replay right after a capture does nothing; later replays run the
    step again and copy its outputs into the captured ones, as a graph
    writes its own output buffers. A replay's launches are taken back out
    of the counts: the runner adds the captured ones."""

    def capture(self, fn):
        self.fn, self.fresh = fn, True
        self.outputs = fn()
        return self.outputs

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        before = tk.launch_counts()
        new = self.fn()
        after = tk.launch_counts()
        tk.add_launch_counts({k: before[k] - after[k] for k in after})
        for out, value in zip(self.outputs, new):
            out.copy_(value)


def test_replays_add_captured_launches(monkeypatch):
    """An engine whose graphs are ``_EagerGraph`` stand-ins serves the
    eager engine's tokens, greedy, sampled and top-k alike (the warm-up
    runs on dropped caches and puts the generator back); each key is
    captured once, every decode step is a replay, the warm-up adds no
    launch and N replays add N x the captured launches."""
    monkeypatch.setattr(dec_ops, "decode_attention",
                        _counting(dec_ops.decode_attention))
    counted_gemm = _counting(gemm_ops.moe_gemm)
    monkeypatch.setattr(gemm_ops, "moe_gemm", counted_gemm)
    monkeypatch.setattr(moe_lib, "moe_gemm", counted_gemm)
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    L = cfg.num_layers
    outs, stats = [], []
    for graph in (False, True):
        eng = _engine(cfg)
        if graph:
            eng._graphs = DecodeGraphs(eng._step, _EagerGraph, eng.stats)
        # the top-k request ends first: the step's key changes mid-run
        reqs = _requests(cfg, max_new=(8, 8, 3), temps=(0.0, 0.8, 0.9),
                         top_ks=(0, 0, 5))
        for r in reqs:
            eng.submit(r)
        tk.reset_launch_counts()
        assert len(eng.run()) == 3
        counts = tk.launch_counts()
        st = eng.stats
        assert counts["decode_attention"] == L * st.steps
        # the capacity MoE runs the expert GEMM in prefill too
        assert counts["moe_gemm"] == L * (st.steps + st.prefill_calls)
        outs.append([r.output for r in reqs])
        stats.append(st)
    assert outs[0] == outs[1]
    assert stats[0].graph_replays == 0
    graphs = eng._graphs.graphs
    # the top-k request took both keys
    assert set(graphs) == {GraphKey(use_topk=False), GraphKey(use_topk=True)}
    assert stats[1].graph_captures == len(graphs) == 2
    assert stats[1].graph_replays == stats[1].steps
    assert graphs[GraphKey(use_topk=False)].launches == {
        **{k: 0 for k in tk.launch_counts()},
        "decode_attention": L, "moe_gemm": L}


def test_graph_engine_is_freed_when_dropped():
    """The step a graph captures holds no reference to its engine: an
    engine with graphs is freed, caches included, when its last reference
    goes, with the garbage collector off (through a cycle its weights and
    caches would stay on the card until the collector ran)."""
    cfg = get_smoke_config("qwen2-1.5b")
    eng = _engine(cfg)
    eng._graphs = DecodeGraphs(eng._step, _EagerGraph, eng.stats)
    for r in _requests(cfg, max_new=(3, 3, 3)):
        eng.submit(r)
    assert len(eng.run()) == 3 and eng.stats.graph_replays > 0
    refs = [weakref.ref(eng), weakref.ref(eng.kv.caches[0]["k"])]
    gc.disable()
    try:
        del eng
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
