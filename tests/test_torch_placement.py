"""Expert-load telemetry and placement in the port's engine, against the
reference engine, on the smoke qwen2-moe-a2.7b (f32, CPU).

``_apply_placement`` is held against the reference's on two 2-rank
placements in a row (the weights bitwise equal, every expert tensor kept
in place). The engine with a FinDEP policy on a gloo expert group of one
rank is held against the reference engine on a one-device plain
``jax.sharding.Mesh``: tracked and untracked engines give the same tokens
(bitwise, and the reference's); the dropped assignments, the per-layer
EWMA loads (1e-12), the ``expert_load()`` snapshot and the resolved plan
keys (with their ``SkewSummary``) equal the reference's; after
``rebalance_now()`` with one hot expert, the epoch, the hot set, the plan
keys left after the invalidation and the tokens that follow do too.
Through the stand-in CUDA graph, a replay after a re-placement gives the
eager step's logits bitwise, with the REP task's expert-GEMM launches, and
an untracked engine keys its graphs as before."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import DepClusterConfig as JaxCluster  # noqa: E402
from repro.core.perf_model import PAPER_A6000 as JAX_A6000  # noqa: E402
from repro.core.planner import FinDEPPlanner as JaxPlanner  # noqa: E402
from repro.core.planner import PlannerConfig as JaxPlannerConfig  # noqa: E402
from repro.placement import rebalance as jax_rebalance  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro.sched import FinDEPPolicy as JaxPolicy  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import DepClusterConfig  # noqa: E402
from repro_torch.core.dep import DepGroups  # noqa: E402
from repro_torch.core.perf_model import PAPER_A6000  # noqa: E402
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.placement import rebalance  # noqa: E402
from repro_torch.runtime import Request, ServingEngine  # noqa: E402
from repro_torch.runtime.decode_graph import (DecodeGraphs,  # noqa: E402
                                              GraphKey)
from repro_torch.sched import FinDEPPolicy  # noqa: E402
from test_torch_decode_graph import _counting, _EagerGraph  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
#: (prompt length, new tokens) of the serve before the re-placement and of
#: the one after it
REQS = ((5, 4), (20, 6), (45, 3), (40, 8))
REQS_AFTER = ((12, 5), (33, 4), (7, 6))
PLACEMENT = dict(replicate_hot_k=1, rebalance_threshold=10.0)
#: the two 2-rank placements of the reference's own permutation test
LOADS = ([8.0, 1.0, 2.0, 1.0], [1.0, 1.0, 1.0, 9.0])


@pytest.fixture(scope="module")
def group():
    groups = DepGroups.single("gloo")
    yield groups
    torch.distributed.destroy_process_group()


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _jax_engine(mesh, **kw):
    cfg = jax_smoke(ARCH)
    policy = JaxPolicy(JaxPlanner(cfg, JaxCluster(8, 3, 5), JAX_A6000,
                                  JaxPlannerConfig(mem_cap_samples=2)))
    return JaxEngine(cfg, num_slots=4, max_context=128, mesh=mesh, seed=0,
                     plan_policy=policy, **kw)


def _engine(params, **kw):
    cfg = get_smoke_config(ARCH)
    policy = FinDEPPolicy(FinDEPPlanner(cfg, DepClusterConfig(8, 3, 5),
                                        PAPER_A6000,
                                        PlannerConfig(mem_cap_samples=2)))
    return ServingEngine(cfg, params=params, num_slots=4, max_context=128,
                         dtype=torch.float32, device="cpu", seed=0,
                         plan_policy=policy, **kw)


def _serve(eng, req_cls, spec=REQS, seed=0):
    rng = np.random.RandomState(seed)
    reqs = [req_cls(prompt=rng.randint(1, 1000, size=n).tolist(),
                    max_new_tokens=m) for n, m in spec]
    for r in reqs:
        eng.submit(r)
    assert len(eng.run()) == len(reqs)
    return [r.output for r in reqs]


def _keys(eng):
    return sorted(repr(k) for k in eng.resolved_plans())


def _snapshot(eng):
    """What the two engines are held on after a serve."""
    tr = eng.load_tracker
    return dict(dropped=eng.stats.dropped_tokens,
                ewma={i: tr.layer_loads(i) for i in range(tr.layers)},
                load=eng.expert_load(), keys=_keys(eng))


@pytest.fixture(scope="module")
def reference():
    """The reference engine on a one-device mesh: untracked, then tracked
    with placement, re-placed, and serving again."""
    mesh = _mesh()
    base = _jax_engine(mesh)
    out = dict(params=params_from_numpy(jax.tree_util.tree_map(
        np.asarray, base.params)))
    out["untracked"] = _serve(base, JaxRequest)
    eng = _jax_engine(mesh, **PLACEMENT)
    out["tracked"] = _serve(eng, JaxRequest)
    out["before"] = _snapshot(eng)
    pl = eng.rebalance_now()
    out["placement"] = (pl.epoch, pl.replicated, pl.perm)
    out["rebalanced_keys"] = _keys(eng)
    out["after_tokens"] = _serve(eng, JaxRequest, REQS_AFTER, seed=1)
    out["after"] = _snapshot(eng)
    eng.close()
    return out


@pytest.fixture(scope="module")
def port(reference, group):
    """The same on the port's engine, on the reference's weights."""
    params = reference["params"]
    out = dict(untracked=_serve(_engine(params, ep_group=group), Request))
    eng = _engine(params, ep_group=group, **PLACEMENT)
    out["tracked"] = _serve(eng, Request)
    out["before"] = _snapshot(eng)
    pl = eng.rebalance_now()
    out["placement"] = (pl.epoch, pl.replicated, pl.perm)
    out["rebalanced_keys"] = _keys(eng)
    out["after_tokens"] = _serve(eng, Request, REQS_AFTER, seed=1)
    out["after"] = _snapshot(eng)
    eng.close()
    return out


def test_tracked_tokens_equal_untracked_and_reference(reference, port):
    assert port["tracked"] == port["untracked"] == reference["tracked"] \
        == reference["untracked"]


@pytest.mark.parametrize("when", ["before", "after"])
def test_load_telemetry_matches_reference(reference, port, when):
    """Dropped assignments, per-layer EWMA loads (1e-12), the
    ``expert_load()`` snapshot and the resolved plan keys, skew included,
    before and after the re-placement."""
    got, want = port[when], reference[when]
    assert got["dropped"] == want["dropped"] > 0
    assert got["ewma"].keys() == want["ewma"].keys()
    for layer, ewma in want["ewma"].items():
        np.testing.assert_allclose(got["ewma"][layer], ewma, rtol=0,
                                   atol=1e-12)
    assert got["load"].keys() == want["load"].keys()
    for k, v in want["load"].items():
        assert got["load"][k] == pytest.approx(v, rel=0, abs=1e-12), k
    assert got["keys"] == want["keys"]
    assert any("SkewSummary" in k for k in got["keys"])


def test_rebalance_now_matches_reference(reference, port):
    """The same epoch, hot set and permutation; the plan keys the
    invalidation leaves; the tokens served after it; and every skew-keyed
    plan after it carries the new epoch."""
    assert port["placement"] == reference["placement"]
    epoch, hot, _ = port["placement"]
    assert epoch == 1 and len(hot) == 1
    assert port["rebalanced_keys"] == reference["rebalanced_keys"]
    assert port["after_tokens"] == reference["after_tokens"]
    assert all("epoch=1" in k for k in port["after"]["keys"]
               if "SkewSummary" in k)
    assert port["after"]["load"]["hot_experts"] == 1.0


def test_apply_placement_permutes_in_place_like_reference():
    """Two 2-rank placements in a row (the second composes on the first):
    every MoE layer's expert weights bitwise the reference's, every
    expert tensor at its address, and the hot weights the physical rows
    of the replicated experts."""
    cfg = jax_smoke(ARCH)
    jeng = JaxEngine(cfg, num_slots=2, max_context=32)
    eng = ServingEngine(get_smoke_config(ARCH), params=params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jeng.params)), num_slots=2,
        max_context=32, dtype=torch.float32, device="cpu")
    moe = [i for i, layer in enumerate(eng.params["layers"])
           if "moe" in layer]
    ptrs = {(i, k): t.data_ptr() for i in moe
            for k, t in eng.params["layers"][i]["moe"]["experts"].items()}
    for epoch, loads in enumerate(LOADS, start=1):
        jpl = jax_rebalance(loads, 2, replicate_hot_k=1, epoch=epoch)
        pl = rebalance(loads, 2, replicate_hot_k=1, epoch=epoch)
        assert pl.perm == jpl.perm and pl.perm != tuple(range(4))
        jeng._apply_placement(jpl)
        eng._apply_placement(pl)
        assert eng.placement is pl
        dp = eng._device_placement
        for i in moe:
            got = eng.params["layers"][i]["moe"]["experts"]
            want = jeng.params["layers"][i]["moe"]["experts"]
            for k, t in got.items():
                assert t.data_ptr() == ptrs[(i, k)]
                assert np.array_equal(t.numpy(), np.asarray(want[k]))
                hot = [pl.perm[e] for e in pl.replicated]
                assert torch.equal(dp.hot_weights[i][k], t[hot])
        assert dp.expert_map.tolist() == list(pl.perm)
    jeng.close()
    eng.close()


def _no_host_copy(fn):
    def guarded(data, *args, **kw):
        if isinstance(data, (list, tuple, np.ndarray)):
            raise AssertionError(f"{fn.__name__} of a host {type(data)} "
                                 "inside the decode step")
        return fn(data, *args, **kw)
    return guarded


def test_graph_replay_after_replacement_equals_eager(reference, group,
                                                     monkeypatch):
    """Stand-in graphs (``_EagerGraph``) against an eager twin, both
    tracked, re-placed with one hot expert after a first serve: every
    decode step's logits bitwise equal; the keys after the re-placement
    carry the engine's ``DevicePlacement``, the tracker's capacity scale
    and ``collect_stats``; the expert GEMM launches 24 x (r1·r2 + r1 for
    REP) per program; and the step copies nothing from the host."""
    counted = _counting(gemm_ops.moe_gemm)
    monkeypatch.setattr(gemm_ops, "moe_gemm", counted)
    monkeypatch.setattr(moe_lib, "moe_gemm", counted)
    params = reference["params"]
    graphed = _engine(params, ep_group=group, **PLACEMENT)
    graphed.decode_graph = True
    graphed._graphs = DecodeGraphs(graphed._step, _EagerGraph,
                                   graphed.stats)
    eager = _engine(params, ep_group=group, **PLACEMENT)
    for eng in (graphed, eager):
        step = eng._step

        def guarded(key, step=step):
            with monkeypatch.context() as m:
                m.setattr(torch, "tensor", _no_host_copy(torch.tensor))
                m.setattr(torch, "as_tensor", _no_host_copy(torch.as_tensor))
                return step(key)
        eng._step = guarded
        if eng is graphed:
            eng._graphs._step = guarded
        _serve(eng, Request)
        eng.rebalance_now()
    before = set(graphed._graphs.graphs)
    n_programs = len(graphed.stats.programs)
    tk.reset_launch_counts()
    for eng in (graphed, eager):
        rng = np.random.RandomState(1)
        for n, m in REQS_AFTER:
            eng.submit(Request(prompt=rng.randint(1, 1000, size=n).tolist(),
                               max_new_tokens=m))
    steps = 0
    while graphed.step() | eager.step():
        assert torch.equal(graphed.last_logits, eager.last_logits)
        steps += 1
    assert steps > 0 and not graphed.waiting
    new = set(graphed._graphs.graphs) - before
    assert new and all(k.placement is graphed._device_placement
                       and k.collect_stats
                       and k.plan.graph.hot_experts == 1 for k in new)
    L = get_smoke_config(ARCH).num_layers
    programs = (graphed.stats.programs[n_programs:]
                + eager.stats.programs[n_programs:])
    assert tk.launch_counts()["moe_gemm"] == L * sum(
        p.graph.r1 * p.graph.r2 + p.graph.r1 for _, p in programs)
    graphed.close()
    eager.close()


def test_untracked_graph_keys_unchanged(reference, group):
    """An engine that tracks no load keys its graphs as before the
    placement fields: no placement, capacity scale 1, no statistics."""
    eng = _engine(reference["params"], ep_group=group)
    eng.decode_graph = True
    eng._graphs = DecodeGraphs(eng._step, _EagerGraph, eng.stats)
    _serve(eng, Request)
    keys = list(eng._graphs.graphs)
    assert keys and all(k == GraphKey(k.use_topk, k.plan) for k in keys)
    assert eng.load_tracker is None and eng.expert_load() is None
    assert eng.stats.dropped_tokens == 0


@pytest.mark.parametrize("history", ["layers", "mixed", "empty-rows"])
def test_tracker_matches_reference(history):
    """The tracker's whole-array EWMA against the reference tracker's loop
    over layers, on the same observations: every layer's loads, the
    aggregate and the imbalance within 1e-12, and the same skew summary
    under no placement, a uniform one and a replicated one."""
    from repro.placement import ExpertLoadTracker as JaxTracker
    from repro.placement import Placement as JaxPlacement
    from repro_torch.placement import ExpertLoadTracker, Placement
    E, L = 8, 5
    rng = np.random.RandomState(3)
    steps = [rng.randint(0, 40, size=(L, E)).astype(np.float32)
             for _ in range(6)]
    if history == "mixed":      # [E] rows, then fewer and more layers
        steps = [steps[0][0], steps[1][:2], steps[2], steps[3][:3]]
    elif history == "empty-rows":   # a layer that routed nothing
        for s in steps[::2]:
            s[1] = 0.0
    ours, ref = ExpertLoadTracker(E), JaxTracker(E)
    for s in steps:
        ours.observe(s)
        ref.observe(s)
    assert ours.layers == ref.layers and \
        ours.observations == ref.observations
    for i in range(ref.layers):
        np.testing.assert_allclose(ours.layer_loads(i), ref.layer_loads(i),
                                   rtol=0, atol=1e-12)
    assert ours.layer_loads(ref.layers) is None
    np.testing.assert_allclose(ours.aggregate(), ref.aggregate(), rtol=0,
                               atol=1e-12)
    assert abs(ours.imbalance() - ref.imbalance()) <= 1e-12
    assign = tuple(e * 2 // E for e in range(E))
    for hot in (None, (), (1, 6)):
        pl = None if hot is None else Placement(E, 2, assign, hot, epoch=1)
        jpl = None if hot is None else JaxPlacement(E, 2, assign, hot, 1)
        assert dataclasses.asdict(ours.summary(pl, num_ranks=2)) == \
            dataclasses.asdict(ref.summary(jpl, num_ranks=2))
    ours.reset()
    assert ours.layers == 0 and ours.observations == 0
