"""A copy of ``repro.core.solver``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

FinDEP configuration search (paper Algorithm 1).

Searches (m_a, r1, m_e, r2, order) maximizing throughput subject to the AG
memory constraint r1 * m_a <= M_cap, exploiting:

  * Theorems 1-2: throughput is monotonically increasing in m_a  -> iterate
    m_a descending and only visit the Pareto frontier of (m_a, r1);
  * Theorem 3:   monotonically non-decreasing in r1              -> use the
    maximal memory-feasible r1 for each m_a;
  * Theorem 4:   the makespan is convex in 1/r2                  -> find r2
    by integer ternary search instead of enumeration.

Three objective modes:
  "analytic"  -- paper-faithful closed forms (Eq. 13 / AASS analogue);
  "simulate"  -- exact event-order simulator (slower, exact);
  "hybrid"    -- analytic search, then re-rank the top-K candidates with the
                 simulator (beyond-paper refinement; default).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Tuple

from repro_torch.core.analytic import (ORDER_AASS, ORDER_ASAS, ORDERS, StageTimes,
                                 makespan_closed_form)
from repro_torch.core.perf_model import StageModels
from repro_torch.core.simulator import simulate_makespan
from repro_torch.core.taskgraph import (CostBreakdown, ExecProgram, LoweringSpec,
                                  TaskCosts, TaskGraph, lower, lower_exec,
                                  schedule)

OBJECTIVES = ("analytic", "simulate", "hybrid")


@dataclass(frozen=True)
class Plan:
    """A fully-specified FinDEP schedule configuration.

    ``breakdown`` carries the modeled per-primitive cost split
    (gemm/attn/comm seconds, normalized to ``makespan``) derived from the
    lowered task graph -- telemetry uses it to attribute measured
    residuals to individual hardware primitives."""

    m_a: int
    r1: int
    m_e: float
    r2: int
    order: str
    throughput: float          # tokens / second
    makespan: float            # seconds for the full T-layer mini-batch
    objective: str = "analytic"
    breakdown: Optional[CostBreakdown] = None

    def exec_graph(self, hot_experts: int = 0,
                   placement_epoch: int = 0) -> TaskGraph:
        """The task graph the DEP executor walks: one layer, one
        micro-batch of the chunk stream (m_a/r1 are realized by the
        caller's batching and T by the transformer loop, so the graph is
        keyed only by what changes the compiled program: r2, order,
        floored m_e — plus the active placement's replica count and
        epoch, so a re-balance keys a fresh trace)."""
        return lower_exec(max(int(self.r2), 1), self.order,
                          max(int(math.floor(self.m_e)), 1),
                          hot_experts=max(int(hot_experts), 0),
                          placement_epoch=int(placement_epoch))

    def exec_program(self, streams: Optional[int] = None,
                     hot_experts: int = 0, placement_epoch: int = 0,
                     interleave: str = "streams",
                     hints: Optional[Tuple[int, ...]] = None
                     ) -> ExecProgram:
        """The executor-visible ``taskgraph.ExecProgram``: the exec
        graph lowered with ``streams`` micro-batch streams (default: the
        plan's r1 — the stream split the solver's makespan assumed) plus
        the emission policy. Under ``interleave="streams"`` the walk
        follows the scheduled start order; priority hints default to the
        schedule of the exec graph under per-task costs derived from the
        plan's modeled ``breakdown`` (``ScheduleResult.priority_hints``),
        falling back to the structural default when the plan carries no
        breakdown."""
        r1 = max(int(streams if streams is not None else self.r1), 1)
        graph = lower_exec(max(int(self.r2), 1), self.order,
                           max(int(math.floor(self.m_e)), 1),
                           hot_experts=max(int(hot_experts), 0),
                           placement_epoch=int(placement_epoch),
                           r1=r1)
        if interleave == "streams" and hints is None:
            hints = self._exec_hints(graph)
        return ExecProgram(graph, interleave, hints)

    def _exec_hints(self, graph: TaskGraph) -> Optional[Tuple[int, ...]]:
        """Priority hints for ``graph`` from the plan's modeled cost
        split: the breakdown's class totals are spread uniformly over
        that class's tasks (attn over ATTN, comm over A2E+E2A, gemm over
        EXP chunks and SHARED segments). Only the relative magnitudes
        matter — they order the interleaved emission. None (no breakdown)
        defers to the structural default."""
        bd = self.breakdown
        if bd is None or bd.total <= 0.0:
            return None
        r1f = max(int(self.r1), 1)
        r2f = max(int(self.r2), 1)
        n_seg = graph.shared_segments
        attn_t = bd.attn / r1f
        comm_t = bd.comm / (2.0 * r1f * r2f)
        gemm_t = bd.gemm / (r1f * (r2f + n_seg))
        costs = TaskCosts(attn=attn_t, shared=gemm_t * n_seg, exp=gemm_t,
                          comm=comm_t, rep=gemm_t)
        return schedule(graph, costs).priority_hints()

    def as_dict(self):
        return dict(m_a=self.m_a, r1=self.r1, m_e=self.m_e, r2=self.r2,
                    order=self.order, throughput=self.throughput,
                    makespan=self.makespan, objective=self.objective)


def plan_breakdown(models: StageModels, T: int, plan: Plan) -> CostBreakdown:
    """Modeled per-primitive (gemm/attn/comm) seconds for one execution
    of ``plan``, from the lowered graph's per-task busy sums, normalized
    so the classes sum to ``plan.makespan`` (the makespan includes idle
    gaps the busy sums don't)."""
    st = StageTimes.from_models(models, plan.m_a, plan.m_e)
    graph = lower(plan, LoweringSpec(T=T,
                                     has_shared=models.spec.n_shared > 0),
                  hot_experts=1 if st.t_rep > 0.0 else 0)
    res = schedule(graph, TaskCosts.from_stage_times(st))
    return res.breakdown().normalized_to(plan.makespan)


@dataclass
class SolverStats:
    evaluations: int = 0
    candidates_visited: int = 0
    wall_time_s: float = 0.0


def _makespan(models: StageModels, T: int, m_a: int, r1: int, r2: int,
              order: str, objective: str) -> float:
    m_e = models.me_from_ma(m_a, r2)
    st = StageTimes.from_models(models, m_a, m_e)
    if objective == "simulate":
        # makespan-only vectorized recurrence: the solver evaluates
        # hundreds of candidates and never reads the per-task schedule
        return simulate_makespan(st, T, r1, r2, order=order)
    return makespan_closed_form(st, T, r1, r2, order)


def _throughput(models: StageModels, T: int, m_a: int, r1: int, r2: int,
                order: str, objective: str) -> Tuple[float, float]:
    ms = _makespan(models, T, m_a, r1, r2, order, objective)
    tokens = r1 * m_a * models.cluster.ag * models.spec.S
    return tokens / ms, ms


def max_r2(models: StageModels, m_a: int, cap: int = 64) -> int:
    """Largest r2 keeping m_e >= 1 token per expert per chunk."""
    s, c = models.spec, models.cluster
    ub = (m_a * c.ag * s.top_k * s.S) // s.E
    return max(1, min(cap, int(ub)))


def solve_r2(models: StageModels, T: int, m_a: int, r1: int, order: str,
             objective: str = "analytic", r2_cap: int = 64,
             stats: Optional[SolverStats] = None) -> Tuple[int, float, float]:
    """1-D search for r2. Ternary search (valid by Theorem 4 convexity) for
    the analytic objective; exhaustive scan when simulating (no convexity
    guarantee). Returns (r2*, throughput, makespan)."""
    hi = max_r2(models, m_a, cap=r2_cap)

    def eval_r2(r2: int) -> Tuple[float, float]:
        if stats is not None:
            stats.evaluations += 1
        return _throughput(models, T, m_a, r1, r2, order, objective)

    if objective == "simulate" or hi <= 6:
        best = max(((r2,) + eval_r2(r2) for r2 in range(1, hi + 1)),
                   key=lambda t: t[1])
        return best

    lo = 1
    while hi - lo > 2:
        m1 = lo + (hi - lo) // 3
        m2 = hi - (hi - lo) // 3
        if eval_r2(m1)[0] >= eval_r2(m2)[0]:
            hi = m2 - 1 if m2 > m1 else m2
        else:
            lo = m1 + 1
    best = max(((r2,) + eval_r2(r2) for r2 in range(lo, hi + 1)),
               key=lambda t: t[1])
    return best


def get_max_r1(m_a: int, mem_cap_samples: int, r1_cap: int = 64) -> int:
    """Paper's getMaxR1: largest r1 with r1 * m_a <= memory capacity."""
    if m_a <= 0 or m_a > mem_cap_samples:
        return 0
    return min(mem_cap_samples // m_a, r1_cap)


def solve(models: StageModels, T: int, mem_cap_samples: int,
          objective: str = "hybrid", r2_cap: int = 64, r1_cap: int = 64,
          orders: Tuple[str, ...] = ORDERS, top_k_refine: int = 8,
          fixed_batch: Optional[int] = None) -> Tuple[Plan, SolverStats]:
    """Algorithm 1. ``fixed_batch`` (samples per AG device) switches to the
    online mode where r1 * m_a must exactly cover the arrived batch."""
    assert objective in OBJECTIVES
    stats = SolverStats()
    t0 = time.perf_counter()
    search_obj = "analytic" if objective == "hybrid" else objective

    candidates: List[Plan] = []
    prev_r1 = -1
    for m_a in range(mem_cap_samples, 0, -1):
        if fixed_batch is not None:
            if fixed_batch % m_a != 0:
                continue
            r1 = fixed_batch // m_a
            if r1 > r1_cap or m_a * r1 > mem_cap_samples:
                continue
        else:
            r1 = get_max_r1(m_a, mem_cap_samples, r1_cap)
            if r1 == 0 or r1 == prev_r1:   # skip non-Pareto-optimal (m_a,r1)
                prev_r1 = r1
                continue
            prev_r1 = r1
        stats.candidates_visited += 1
        for order in orders:
            r2, tps, ms = solve_r2(models, T, m_a, r1, order,
                                   objective=search_obj, r2_cap=r2_cap,
                                   stats=stats)
            m_e = models.me_from_ma(m_a, r2)
            candidates.append(Plan(m_a=m_a, r1=r1, m_e=m_e, r2=r2,
                                   order=order, throughput=tps, makespan=ms,
                                   objective=search_obj))

    if not candidates:
        raise ValueError("no feasible (m_a, r1) under the memory constraint")

    candidates.sort(key=lambda p: p.throughput, reverse=True)

    if objective == "hybrid":
        # Re-rank the analytic top-K with the exact simulator.
        refined = []
        for p in candidates[:top_k_refine]:
            tps, ms = _throughput(models, T, p.m_a, p.r1, p.r2, p.order,
                                  "simulate")
            stats.evaluations += 1
            refined.append(Plan(m_a=p.m_a, r1=p.r1, m_e=p.m_e, r2=p.r2,
                                order=p.order, throughput=tps, makespan=ms,
                                objective="hybrid"))
        refined.sort(key=lambda p: p.throughput, reverse=True)
        best = refined[0]
    else:
        best = candidates[0]

    # tag the winning plan with its modeled per-primitive cost split (one
    # extra graph schedule; candidates stay untagged to keep the search
    # cheap)
    best = replace(best, breakdown=plan_breakdown(models, T, best))
    stats.wall_time_s = time.perf_counter() - t0
    return best, stats


def solve_brute_force(models: StageModels, T: int, mem_cap_samples: int,
                      objective: str = "analytic", r2_cap: int = 16,
                      r1_cap: int = 16,
                      fixed_batch: Optional[int] = None) -> Plan:
    """Exhaustive reference over (m_a, r1, r2, order); for tests."""
    best: Optional[Plan] = None
    for m_a in range(1, mem_cap_samples + 1):
        if fixed_batch is not None:
            if fixed_batch % m_a:
                continue
            r1_list = [fixed_batch // m_a]
        else:
            r1_list = range(1, get_max_r1(m_a, mem_cap_samples, r1_cap) + 1)
        for r1 in r1_list:
            if r1 == 0 or r1 > r1_cap or r1 * m_a > mem_cap_samples:
                continue
            for order in ORDERS:
                for r2 in range(1, max_r2(models, m_a, r2_cap) + 1):
                    tps, ms = _throughput(models, T, m_a, r1, r2, order,
                                          objective)
                    if best is None or tps > best.throughput:
                        m_e = models.me_from_ma(m_a, r2)
                        best = Plan(m_a=m_a, r1=r1, m_e=m_e, r2=r2,
                                    order=order, throughput=tps, makespan=ms,
                                    objective=objective)
    assert best is not None
    return best
