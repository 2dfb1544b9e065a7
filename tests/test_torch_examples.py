"""The port's user entry points and last public helpers against the
reference: an admission policy of the older 3-argument form through both
``BatchScheduler``s (dense and paged KV, with and without a token
budget); ``core.dep.as_exec_graph`` on solved plans; ``launch.quickstart``
and ``launch.online_adaptation`` against ``examples/quickstart.py`` and
``examples/online_adaptation.py`` (run through ``runpy``, stdout
captured): the same printed plans, throughputs to 1e-9 relative and
cache counts; quickstart's step 5 on the reference's weights against the
reference's forward at f32 1e-5, and its DEP branch on two gloo ranks."""
import contextlib
import dataclasses
import io
import os
import re
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import DepClusterConfig as JaxCluster  # noqa: E402
from repro.core import PAPER_A6000 as JAX_A6000  # noqa: E402
from repro.core import FinDEPPlanner as JaxPlanner  # noqa: E402
from repro.core import best_pppipe as jax_best_pppipe  # noqa: E402
from repro.core import naive_plan as jax_naive_plan  # noqa: E402
from repro.core.analytic import StageTimes as JaxStageTimes  # noqa: E402
from repro.core.dep import as_exec_graph as jax_as_exec_graph  # noqa: E402
from repro.core.planner import PlannerConfig as JaxPlannerConfig  # noqa: E402
from repro.core.simulator import simulate_pppipe as jax_sim_pp  # noqa: E402
from repro.launch.steps import make_model as jax_make_model  # noqa: E402
from repro.runtime import BatchScheduler as JaxScheduler  # noqa: E402
from repro.runtime import KVCacheManager as JaxKV  # noqa: E402
from repro.runtime import PagedKVCacheManager as JaxPagedKV  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.sched import FinDEPPolicy as JaxFinDEPPolicy  # noqa: E402
from repro.sched import PlanCache as JaxPlanCache  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import DepClusterConfig  # noqa: E402
from repro_torch.core import PAPER_A6000, FinDEPPlanner  # noqa: E402
from repro_torch.core import taskgraph as tg  # noqa: E402
from repro_torch.core.dep import as_exec_graph  # noqa: E402
from repro_torch.core.planner import PlannerConfig  # noqa: E402
from repro_torch.launch import online_adaptation, quickstart  # noqa: E402
from repro_torch.runtime import (BatchScheduler, KVCacheManager,  # noqa: E402
                                 Request)
from repro_torch.runtime.paging import PagedKVCacheManager  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


# ---------------------------------------------------------------------------
# (a) a 3-argument admission policy


class ThreeArgShortestFirst:
    """An admission policy of the older form: ``admit`` takes no
    ``cost_fn``. Admits the shortest waiting prompts first, at most
    ``free_slots`` of them and, under a budget, while their prompt tokens
    fit it. The scheduler takes them out of ``waiting``."""

    def __init__(self):
        self.calls = 0

    def admit(self, waiting, free_slots, token_budget):
        self.calls += 1
        picked, total = [], 0
        for req in sorted(waiting, key=lambda r: len(r.prompt)):
            if len(picked) == free_slots:
                break
            if token_budget is not None and picked \
                    and total + len(req.prompt) > token_budget:
                continue
            picked.append(req)
            total += len(req.prompt)
        return picked


def _kv_pair(layout):
    if layout == "dense":
        return KVCacheManager(3, 160), JaxKV(3, 160)
    kw = dict(block_size=16, num_blocks=40)
    return PagedKVCacheManager(3, 160, **kw), JaxPagedKV(3, 160, **kw)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("budget", [None, 60])
def test_three_argument_admission_matches_reference(layout, budget):
    """A policy without ``cost_fn`` runs through both schedulers (the
    port's retries without it, as the reference does) and both admit the
    same requests, in the same order, at every step."""
    sizes = [40, 3, 120, 17, 9, 70, 33, 1, 55, 12]
    prefix = list(range(1000, 1032))           # two whole pages, shared
    prompts = [(prefix if i % 3 == 0 else []) + list(range(n))
               for i, n in enumerate(sizes)]
    tw = [Request(prompt=p, max_new_tokens=2, arrival_t=float(i))
          for i, p in enumerate(prompts)]
    jw = [JaxRequest(prompt=p, max_new_tokens=2, arrival_t=float(i))
          for i, p in enumerate(prompts)]
    tkv, jkv = _kv_pair(layout)
    tpol, jpol = ThreeArgShortestFirst(), ThreeArgShortestFirst()
    ts = BatchScheduler(admission=tpol, token_budget=budget)
    js = JaxScheduler(admission=jpol, token_budget=budget)
    admitted = []
    for _ in range(8):
        tp, jp = ts.build_step(tw, tkv), js.build_step(jw, jkv)
        got = [[(list(r.prompt), s) for r, s in zip(g.requests, g.slots)]
               for g in tp.prefills]
        want = [[(list(r.prompt), s) for r, s in zip(g.requests, g.slots)]
                for g in jp.prefills]
        assert got == want
        assert [g.bucket for g in tp.prefills] == \
            [g.bucket for g in jp.prefills]
        assert tp.decode_slots == jp.decode_slots
        assert [r.prompt for r in tw] == [r.prompt for r in jw]
        admitted += [r for g in tp.prefills for r in g.requests]
        for slot in list(tkv.live_slots())[:1]:   # one slot finishes a step
            tkv.free(slot)
            jkv.free(slot)
    assert tpol.calls == jpol.calls > 0
    assert len(admitted) == len(sizes)


# ---------------------------------------------------------------------------
# (b) as_exec_graph

#: (arch, seq_len, batch per device, order override): deepseek-v2-lite has
#: shared experts, qwen3-moe none; the solver's AASS plans at r2 > 1 and
#: the same plans as ASAS; an ASAS plan at r2 = 1
GRAPH_PLANS = [("deepseek-v2-lite", 4096, None, None),
               ("deepseek-v2-lite", 4096, None, "ASAS"),
               ("deepseek-v2-lite", 512, None, None),
               ("qwen3-moe", 8192, 4, None),
               ("qwen3-moe", 8192, 4, "ASAS"),
               ("qwen3-moe", 2048, 1, None)]


def _graph_fields(graph):
    return (graph.T, graph.r1, graph.r2, graph.order, graph.m_e,
            graph.has_shared,
            [(t.kind, t.layer, t.mb, t.chunk, t.deps) for t in graph.tasks])


@pytest.mark.parametrize("arch,S,batch,order", GRAPH_PLANS,
                         ids=[f"{a}-S{s}-b{b}-{o or 'solved'}"
                              for a, s, b, o in GRAPH_PLANS])
def test_as_exec_graph_matches_reference(arch, S, batch, order):
    cfg = PlannerConfig(mem_cap_samples=8)
    plan = FinDEPPlanner(get_config(arch), DepClusterConfig(8, 3, 5),
                         PAPER_A6000, cfg).plan(S, batch)
    jplan = JaxPlanner(jax_config(arch), JaxCluster(8, 3, 5), JAX_A6000,
                       JaxPlannerConfig(**dataclasses.asdict(cfg))).plan(
                           S, batch)
    if order is not None:
        plan = dataclasses.replace(plan, order=order)
        jplan = dataclasses.replace(jplan, order=order)
    assert plan.r2 == jplan.r2 and plan.order == jplan.order
    graph = as_exec_graph(plan)
    assert isinstance(graph, tg.TaskGraph)
    assert _graph_fields(graph) == _graph_fields(jax_as_exec_graph(jplan))
    assert {t.kind for t in graph.tasks} >= {"A2E", "EXP", "E2A"}
    if plan.r2 > 1:
        assert len(graph.tasks_of("EXP")) == plan.r2


# ---------------------------------------------------------------------------
# (c) the two examples against the reference's


def _run_reference(name):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"),
                       run_name="__main__")
    return buf.getvalue()


def _run_port(name):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if name == "quickstart":
            out = quickstart.main(["--device", "cpu"])
        else:
            out = online_adaptation.main()
    return buf.getvalue(), out


#: numbers a run prints that are wall times (solver ms), not results
WALL = {"quickstart": re.compile(r"(solve time:) [0-9.]+ ms"),
        "online_adaptation": re.compile(
            r"^(\s*\d+ m_a=\S+ r1=\S+ r2=\s*\S+\s+\S+)\s+[0-9.]+|"
            r"\([0-9.]+ ms total solver time\)", re.M)}


def _masked(name, text):
    return WALL[name].sub(lambda m: (m.group(1) or "") + " <ms>", text)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _reference_quickstart():
    cfg = jax_config("deepseek-v2-lite")
    planner = JaxPlanner(cfg, JaxCluster(num_devices=8, ag=3, eg=5),
                         JAX_A6000, JaxPlannerConfig(mem_cap_samples=8))
    plan = planner.plan(seq_len=4096)
    models = planner.stage_models(4096)
    T = len(cfg.moe_layer_indices())
    return (plan, jax_best_pppipe(models, T, 8, r1_cap=8),
            jax_naive_plan(models, T, 8))


def _reference_arrivals():
    """The reference example's trace, step by step: (S, plan, FinDEP and
    static PPPipe tokens/s) per arrival, and its plan cache."""
    cluster = JaxCluster(num_devices=8, ag=3, eg=5)
    planner = JaxPlanner(jax_config("deepseek-v2-lite"), cluster, JAX_A6000,
                         JaxPlannerConfig(mem_cap_samples=4, r1_cap=4))
    cache = JaxPlanCache(JaxFinDEPPolicy(planner))
    T = planner.num_moe_layers()
    pp_cfg = jax_best_pppipe(planner.stage_models(2048), T, 4, r1_cap=4)
    rng = np.random.RandomState(0)
    rows = []
    for _ in range(8):
        S = int(rng.choice([512, 1024, 2048, 4096, 8192]))
        plan = cache.get("prefill", S, 4)
        models = planner.stage_models(S)
        st = JaxStageTimes.from_models(models, pp_cfg.m_a,
                                       models.me_from_ma(pp_cfg.m_a, 1))
        res = jax_sim_pp(st, T, pp_cfg.r1)
        rows.append((S, plan, plan.throughput,
                     pp_cfg.r1 * pp_cfg.m_a * cluster.ag * S / res.makespan))
    return pp_cfg, rows, cache


@pytest.mark.parametrize("name", ["quickstart", "online_adaptation"])
def test_example_matches_reference(name):
    want = _run_reference(name)
    got, out = _run_port(name)
    if name == "quickstart":
        # step 5's line: the same shape, device count and MoE path; its
        # aux loss comes from other weights (the reference's PRNGKey(0)),
        # held against the reference's on its own weights below
        step5 = re.compile(r"aux loss \S+, devices=(\d+)(, device=[^,\s]+)?")
        got = step5.sub(r"devices=\1", got)
        want = step5.sub(r"devices=\1", want)
        plan, pp, nv = _reference_quickstart()
        pairs = [(out.plan, plan), (out.pppipe, pp), (out.naive, nv)]
        for a, b in pairs:
            assert (a.m_a, a.r1, a.r2) == (b.m_a, b.r1, b.r2)
            assert _rel(a.throughput, b.throughput) < 1e-9
        assert (out.plan.order, out.plan.m_e) == (plan.order, plan.m_e)
        assert out.executed.moe_impl == "capacity"
    else:
        pp_cfg, rows, cache = _reference_arrivals()
        assert (out.pppipe.m_a, out.pppipe.r1) == (pp_cfg.m_a, pp_cfg.r1)
        assert len(out.arrivals) == len(rows)
        for a, (S, plan, fd, pp) in zip(out.arrivals, rows):
            assert a.seq_len == S
            assert (a.plan.m_a, a.plan.r1, a.plan.r2, a.plan.order) == \
                (plan.m_a, plan.r1, plan.r2, plan.order)
            assert _rel(a.findep_tps, fd) < 1e-9
            assert _rel(a.pppipe_tps, pp) < 1e-9
        s, js = out.cache.stats, cache.stats
        assert (s.hits, s.misses, s.lookups) == \
            (js.hits, js.misses, js.lookups)
    assert _masked(name, got) == _masked(name, want)


# ---------------------------------------------------------------------------
# (d) quickstart's step 5


def _reference_step5():
    """The reference's step 5 without a mesh: its smoke model on
    ``PRNGKey(0)`` weights over ``PRNGKey(1)`` tokens, at f32."""
    plan, _, _ = _reference_quickstart()
    smoke = jax_smoke("deepseek-v2-lite")
    model = jax_make_model(smoke, None, plan=plan, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                                smoke.vocab_size)
    logits, _, aux = model.forward(params, tokens)
    return (plan, jax.tree_util.tree_map(np.asarray, params),
            np.asarray(tokens), np.asarray(logits), float(aux))


def _port_plan():
    return FinDEPPlanner(get_config("deepseek-v2-lite"),
                         DepClusterConfig(8, 3, 5), PAPER_A6000,
                         PlannerConfig(mem_cap_samples=8)).plan(seq_len=4096)


def test_quickstart_step5_matches_reference_forward():
    _, params, tokens, logits, aux = _reference_step5()
    out = quickstart.execute(_port_plan(), "cpu",
                             params=params_from_numpy(params),
                             tokens=torch.tensor(tokens))
    assert out.moe_impl == "capacity" and out.devices == 1
    assert tuple(out.logits.shape) == logits.shape
    np.testing.assert_allclose(out.logits.numpy(), logits, rtol=1e-5,
                               atol=1e-5)
    assert abs(out.aux - aux) <= 1e-5 * max(1.0, abs(aux))


def test_quickstart_step5_on_two_ranks_runs_the_plan():
    """The DEP branch: two gloo ranks on a (1, 2) mesh, each holding half
    the experts, run the solved plan; rank 0's logits equal the one-device
    forward's on the same seeds at f32 1e-5 (the same experts' rows, a
    different MoE path)."""
    plan = _port_plan()
    out = quickstart.execute_on_ranks(plan, 2, backend="gloo")
    one = quickstart.execute(plan, "cpu")
    assert (out.moe_impl, out.devices) == ("dep", 2)
    assert out.logits.shape == one.logits.shape
    assert torch.isfinite(out.logits).all()
    torch.testing.assert_close(out.logits, one.logits, rtol=1e-5, atol=1e-5)
