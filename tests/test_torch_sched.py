"""The port's copies of the planning layer (``repro_torch.core``,
``sched``, ``placement``, ``analysis``) held against their originals in
one process: the same ``Plan`` from ``FinDEPPlanner.plan`` on the
Table-5/7 shapes (``PAPER_A6000``, 3 + 5 devices), the same executor
walk and priority hints for every (r1, r2, order, m_e), the same plan
cache accounting over one sequence of lookups, and the same graphcheck
violations on tampered hint vectors."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.analysis.graphcheck import check_exec_program as jax_check
from repro.analysis.report import codes as jax_codes
from repro.configs import get_config as jax_config
from repro.configs.base import DepClusterConfig as JaxCluster
from repro.core import perf_model as jax_perf
from repro.core import taskgraph as jax_tg
from repro.core.planner import FinDEPPlanner as JaxPlanner
from repro.core.planner import PlannerConfig as JaxPlannerConfig
from repro.placement import Placement as JaxPlacement
from repro.placement import rebalance as jax_rebalance
from repro.placement import zipf_loads as jax_zipf
from repro.sched import OccupancySummary as JaxOccupancy
from repro.sched import PlanCache as JaxPlanCache
from repro.sched import make_policy as jax_make_policy
from repro_torch.analysis.graphcheck import check_exec_program
from repro_torch.analysis.report import codes
from repro_torch.configs import get_config
from repro_torch.configs.base import DepClusterConfig
from repro_torch.core import perf_model
from repro_torch.core import taskgraph as tg
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig
from repro_torch.placement import Placement, rebalance, zipf_loads
from repro_torch.sched import (POLICIES, OccupancySummary, PlanCache,
                               make_policy)

#: Table 5 (both backbones at the paper depths, four lengths) and Table 7
#: (deepseek, the overlap study's planner with r1 up to 4)
BACKBONES = {"deepseek-v2-lite": 8, "qwen3-moe": 24}
TABLE5 = [(arch, S) for arch in BACKBONES for S in (1024, 2048, 4096, 8192)]
EXEC = list(itertools.product((1, 2, 4), (1, 2, 4), ("ASAS", "AASS"),
                              (1, 3)))


def _planners(arch, **kw):
    cfg = PlannerConfig(mem_cap_samples=4, r2_cap=32,
                        T_override=BACKBONES[arch], **kw)
    jcfg = JaxPlannerConfig(**dataclasses.asdict(cfg))
    return (FinDEPPlanner(get_config(arch), DepClusterConfig(8, 3, 5),
                          perf_model.PAPER_A6000, cfg),
            JaxPlanner(jax_config(arch), JaxCluster(8, 3, 5),
                       jax_perf.PAPER_A6000, jcfg))


def _plan_fields(plan):
    return dataclasses.asdict(plan)


def test_config_and_profile_copies_equal_originals():
    for arch in ("qwen2-moe-a2.7b",) + tuple(BACKBONES):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch))
    assert set(perf_model.PROFILES) == set(jax_perf.PROFILES)
    for name, hw in perf_model.PROFILES.items():
        assert dataclasses.asdict(hw) == \
            dataclasses.asdict(jax_perf.PROFILES[name])


@pytest.mark.parametrize("arch,S", TABLE5, ids=lambda v: str(v))
def test_table5_plans_equal(arch, S):
    port, ref = _planners(arch)
    for batch in (None, 1, 4):
        got, want = port.plan(S, batch), ref.plan(S, batch)
        assert _plan_fields(got) == _plan_fields(want)


@pytest.mark.parametrize("S", (1024, 2048, 4096))
def test_table7_plans_and_policies_equal(S):
    """The overlap study's planner (r1 up to 4) through every policy."""
    port, ref = _planners("deepseek-v2-lite", r1_cap=4)
    for name in POLICIES:
        got = make_policy(name, port, static_seq_len=2048)
        want = jax_make_policy(name, ref, static_seq_len=2048)
        assert _plan_fields(got.resolve("prefill", S)) == \
            _plan_fields(want.resolve("prefill", S))


def _walk(program):
    return [(t.kind, t.layer, t.mb, t.chunk, t.deps)
            for t in program.walk()]


@pytest.mark.parametrize("r1,r2,order,m_e", EXEC,
                         ids=lambda v: str(v))
def test_exec_program_walk_and_hints_equal(r1, r2, order, m_e):
    """The executor's program: the lowered graph, the priority hints the
    schedule gives under a plan's cost split, and the walk in both
    interleave modes."""
    g, jg = tg.lower_exec(r2, order, m_e, r1=r1), \
        jax_tg.lower_exec(r2, order, m_e, r1=r1)
    assert [dataclasses.astuple(t) for t in g.tasks] == \
        [dataclasses.astuple(t) for t in jg.tasks]
    costs = dict(attn=4.0, shared=1.0, exp=2.0, comm=3.0, gate=0.5,
                 rep=0.5)
    hints = tg.schedule(g, tg.TaskCosts(**costs)).priority_hints()
    assert hints == jax_tg.schedule(
        jg, jax_tg.TaskCosts(**costs)).priority_hints()
    for mode in ("off", "streams"):
        prog = tg.ExecProgram(g, mode, hints if mode == "streams" else None)
        jprog = jax_tg.ExecProgram(jg, mode,
                                   hints if mode == "streams" else None)
        assert _walk(prog) == _walk(jprog)
        assert prog.capacity_multiple == jprog.capacity_multiple == \
            r1 * r2 * m_e


def test_plan_exec_program_equal():
    """``Plan.exec_program`` of solved plans: the same program (graph,
    interleave, hints) at the plan's r1 and at a prefill stream split."""
    port, ref = _planners("qwen3-moe")
    for S in (1024, 4096):
        p, jp = port.plan(S), ref.plan(S)
        for streams in (None, 2):
            prog = p.exec_program(streams=streams)
            jprog = jp.exec_program(streams=streams)
            assert prog.hints == jprog.hints
            assert _walk(prog) == _walk(jprog)


def _occupancies(cls):
    return [cls.from_lengths(lengths, max_bucket=4096) for lengths in
            ([100, 300], [120, 280], [100, 300, 900], [2000], [100, 300],
             [3000, 3000, 3000, 3000], [2000])]


def test_plan_cache_accounting_equal():
    """One sequence of prefill and decode lookups through a cache of
    three entries: the same hits, misses, evictions and resolved plans."""
    port, ref = _planners("qwen3-moe")
    cache = PlanCache(make_policy("findep", port), capacity=3)
    jcache = JaxPlanCache(jax_make_policy("findep", ref), capacity=3)
    prefill = [(1024, 2), (2048, 1), (1024, 2), (4096, 4), (2048, 1),
               (1024, 2)]
    for (S, b), occ, jocc in zip(prefill, _occupancies(OccupancySummary),
                                 _occupancies(JaxOccupancy)):
        assert _plan_fields(cache.get("prefill", S, b)) == \
            _plan_fields(jcache.get("prefill", S, b))
        assert _plan_fields(cache.get("decode", occupancy=occ)) == \
            _plan_fields(jcache.get("decode", occupancy=jocc))
    counts = ("hits", "misses", "evictions", "invalidations", "refreshes")
    got, want = cache.stats.as_dict(), jcache.stats.as_dict()
    assert {k: got[k] for k in counts} == {k: want[k] for k in counts}
    st = cache.stats
    assert st.hits and st.misses and st.evictions
    assert [repr(k) for k in cache.entries()] == \
        [repr(k) for k in jcache.entries()]


def test_placement_copy_equal():
    """The placement copy the executor's ``expert_map`` and REP use: the
    same re-balance of a Zipf load, its perm and its replica set."""
    perm = np.random.RandomState(3).permutation(64)
    loads, jloads = zipf_loads(64, 1.2, perm), jax_zipf(64, 1.2, perm)
    assert list(loads) == list(jloads)
    pl = rebalance(loads, 8, replicate_hot_k=2, epoch=1)
    jpl = jax_rebalance(jloads, 8, replicate_hot_k=2, epoch=1)
    assert (pl.assignment, pl.replicated, pl.perm, pl.epoch) == \
        (jpl.assignment, jpl.replicated, jpl.perm, jpl.epoch)
    assert Placement.uniform(64, 8).perm == JaxPlacement.uniform(64, 8).perm


def test_graphcheck_flags_tampered_hints_as_original():
    """Tampered hint vectors (reversed, short, not a permutation) draw
    the same violation codes from both checkers; sound ones draw none."""
    costs = tg.TaskCosts(attn=4.0, shared=1.0, exp=2.0, comm=3.0, gate=0.0,
                         rep=0.5)
    g, jg = tg.lower_exec(4, "ASAS", r1=2), jax_tg.lower_exec(4, "ASAS",
                                                               r1=2)
    good = tg.schedule(g, costs).priority_hints()
    n = len(g.tasks)
    for hints, want in ((good, []), (tuple(reversed(good)),
                                     ["hint-dep-order"]),
                        (good[:-1], ["hint-length"]), ((0,) * n, None)):
        got = codes(check_exec_program(tg.ExecProgram(g, "streams", hints)))
        assert got == jax_codes(jax_check(
            jax_tg.ExecProgram(jg, "streams", hints)))
        if want is not None:
            assert got == want
        else:
            assert "hint-not-permutation" in got
