"""The port's engine with a plan policy (FinDEP, the paper's planner on
``PAPER_A6000``) against the reference's engine, on the smoke
qwen2-moe-a2.7b (f32, CPU): without an expert group the plans are
resolved, chunk the prefill groups and never reach the model, as in the
reference engine without a mesh; with a gloo expert group of one rank the
MoE layers walk each plan's ``ExecProgram`` (DEP), as the reference
engine does on a one-device mesh. Through the stand-in CUDA graph, the
graphs are warmed up once before the serve and a program first seen
mid-serve is captured once, with no eager run."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import DepClusterConfig as JaxCluster  # noqa: E402
from repro.core.perf_model import PAPER_A6000 as JAX_A6000  # noqa: E402
from repro.core.planner import FinDEPPlanner as JaxPlanner  # noqa: E402
from repro.core.planner import PlannerConfig as JaxPlannerConfig  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro.sched import FinDEPPolicy as JaxPolicy  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import DepClusterConfig  # noqa: E402
from repro_torch.core.dep import DepGroups, as_exec_program  # noqa: E402
from repro_torch.core.perf_model import PAPER_A6000  # noqa: E402
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.runtime import Request, ServingEngine  # noqa: E402
from repro_torch.runtime.decode_graph import (DecodeGraphs,  # noqa: E402
                                              GraphKey)
from repro_torch.sched import FinDEPPolicy  # noqa: E402
from test_torch_decode_graph import _counting, _EagerGraph  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
#: (prompt length, new tokens): one bucket of four prompts, which the
#: plan of a 2-sample memory cap prefills in two calls; the slots finish
#: one by one, so the decode composition and its plan change mid-serve
REQS = ((5, 4), (20, 6), (45, 3), (40, 8))
MEM_CAP = 2


@pytest.fixture(scope="module")
def group():
    """A gloo expert group of one rank (the default process group of this
    process, over an in-process store)."""
    groups = DepGroups.single("gloo")
    yield groups
    torch.distributed.destroy_process_group()


def _jax_engine(mesh=None):
    cfg = jax_smoke(ARCH)
    policy = JaxPolicy(JaxPlanner(cfg, JaxCluster(8, 3, 5), JAX_A6000,
                                  JaxPlannerConfig(mem_cap_samples=MEM_CAP)))
    return JaxEngine(cfg, num_slots=4, max_context=128, mesh=mesh, seed=0,
                     plan_policy=policy)


def _engine(params, **kw):
    cfg = get_smoke_config(ARCH)
    policy = FinDEPPolicy(FinDEPPlanner(
        cfg, DepClusterConfig(8, 3, 5), PAPER_A6000,
        PlannerConfig(mem_cap_samples=MEM_CAP)))
    return ServingEngine(cfg, params=params, num_slots=4, max_context=128,
                         dtype=torch.float32, device="cpu", seed=0,
                         plan_policy=policy, **kw)


def _record_prefills(eng):
    """Record the token shape of every prefill call of ``eng``'s model."""
    calls = []
    prefill = eng.model.prefill

    def wrapper(params, tokens, *args, **kw):
        calls.append(tuple(tokens.shape))
        return prefill(params, tokens, *args, **kw)

    eng.model.prefill = wrapper
    return calls


def _serve(eng, req_cls):
    rng = np.random.RandomState(0)
    reqs = [req_cls(prompt=rng.randint(1, 1000, size=n).tolist(),
                    max_new_tokens=m) for n, m in REQS]
    for r in reqs:
        eng.submit(r)
    assert len(eng.run()) == len(reqs)
    return [r.output for r in reqs]


def _plans(eng):
    return {repr(k): p.as_dict() for k, p in eng.resolved_plans().items()}


def test_no_group_plans_tokens_and_chunks_match_reference():
    """No expert group: the same greedy tokens, the same resolved plans
    under the same keys, and the same prefill calls (a bucket of four
    chunked into two) as the reference engine without a mesh; no plan
    reaches the model, whose MoE layers run the capacity path."""
    jeng = _jax_engine()
    teng = _engine(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jeng.params)))
    assert teng.model.ctx.moe_impl == "capacity"
    jcalls, tcalls = _record_prefills(jeng), _record_prefills(teng)
    assert _serve(teng, Request) == _serve(jeng, JaxRequest)
    assert _plans(teng) == _plans(jeng)
    assert any(k.startswith("('decode'") for k in _plans(teng))
    assert tcalls == jcalls
    assert tcalls[:2] == [(2, 64), (2, 64)]
    assert teng.stats.programs == []


def test_group_of_one_matches_reference_on_one_device_mesh(group):
    """A gloo expert group of one rank (DEP on): the same greedy tokens
    and resolved plans as the reference engine on a one-device mesh; the
    MoE layers of every model call walk that call's program."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jeng = _jax_engine(mesh)
    teng = _engine(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jeng.params)), ep_group=group)
    assert teng.model.ctx.moe_impl == "dep"
    assert _serve(teng, Request) == _serve(jeng, JaxRequest)
    assert _plans(teng) == _plans(jeng)
    st = teng.stats
    phases = [ph for ph, _ in st.programs]
    assert phases.count("prefill") == st.prefill_calls
    assert phases.count("decode") == st.steps


class _LoggedGraphs(DecodeGraphs):
    """``DecodeGraphs`` over a step that logs its runs: each warm-up's
    keys, the decode step count at each capture, and the step's runs
    outside the warm-up."""

    def __init__(self, eng):
        self.eng = eng
        self.warm_ups, self.captured_at, self.runs = [], [], 0
        self._warming = False
        step = eng._step

        def logged(key):
            if not self._warming:
                self.runs += 1
            return step(key)
        super().__init__(logged, _EagerGraph, eng.stats)

    def warm_up(self, keys):
        keys = list(keys)
        self.warm_ups.append((self.eng.stats.steps, keys))
        self._warming = True
        try:
            super().warm_up(keys)
        finally:
            self._warming = False

    def _capture(self, key):
        self.captured_at.append(self.eng.stats.steps)
        return super()._capture(key)


def test_new_program_mid_serve_is_captured_without_eager_run(group,
                                                             monkeypatch):
    """Graph keys carry the DEP program: an engine with stand-in graphs
    serves the eager engine's tokens. It warms up once, before the first
    step, on the keys it can name up front (both sampling variants on the
    unchunked program), on caches it then drops; a program first seen
    mid-serve is captured once with no eager run of its own (the
    stand-in's capture runs the step in place of the replay that follows
    it, so the step runs once per decode step); every decode step is one
    replay, and the expert GEMM runs once per layer and (stream, chunk)
    of each call's program."""
    counted = _counting(gemm_ops.moe_gemm)
    monkeypatch.setattr(gemm_ops, "moe_gemm", counted)
    monkeypatch.setattr(moe_lib, "moe_gemm", counted)
    L = get_smoke_config(ARCH).num_layers
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, _jax_engine().params))
    eager = _engine(params, ep_group=group)
    graphed = _engine(params, ep_group=group)
    graphed.decode_graph = True
    graphed._graphs = graphs = _LoggedGraphs(graphed)
    want = _serve(eager, Request)
    tk.reset_launch_counts()
    assert _serve(graphed, Request) == want
    st = graphed.stats
    first = as_exec_program(None)
    assert graphs.warm_ups == [(0, [GraphKey(False, first),
                                    GraphKey(True, first)])]
    keys = set(graphs.graphs)
    programs = {p for ph, p in st.programs if ph == "decode"}
    assert {k.plan for k in keys} == programs and len(programs) >= 2
    assert st.graph_captures == len(keys) == len(graphs.captured_at)
    assert max(graphs.captured_at) > 0       # a key first seen mid-serve
    assert graphs.runs == st.steps == st.graph_replays
    for key, captured in graphs.graphs.items():
        assert captured.launches["moe_gemm"] == \
            L * key.plan.graph.r1 * key.plan.graph.r2
    assert tk.launch_counts()["moe_gemm"] == L * sum(
        p.graph.r1 * p.graph.r2 for _, p in st.programs)


def test_validate_rejects_tampered_hints(monkeypatch):
    """``validate=True`` runs graphcheck on each distinct program before
    it is used: a reversed hint vector raises at plan time, with the
    reference's violation code; sound programs serve and are checked
    once each."""
    from repro_torch.analysis import AnalysisError
    from repro_torch.core.solver import Plan
    from repro_torch.core.taskgraph import ExecProgram
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, _jax_engine().params))
    eng = _engine(params, validate=True)
    assert _serve(eng, Request)
    checked = len(eng._validated_programs)
    assert checked >= 1 and eng.stats.programs == []
    orig = Plan.exec_program

    def tampered(self, *a, **kw):
        prog = orig(self, *a, **kw)
        return ExecProgram(prog.graph, prog.interleave,
                           tuple(reversed(prog.hints)))

    monkeypatch.setattr(Plan, "exec_program", tampered)
    eng = _engine(params, validate=True)
    eng.submit(Request(prompt=[1, 2, 3, 4, 5], max_new_tokens=2))
    with pytest.raises(AnalysisError) as err:
        eng.run()
    assert any(v.code == "hint-dep-order" for v in err.value.violations)
