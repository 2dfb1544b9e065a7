"""A copy of ``repro.core.baselines``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Baselines the paper compares against: naive DEP, PPPipe
(MegaScale-Infer) — including the "best-configured PPPipe" search used in
Tables 5-6 (optimal m_a, r1 for PPPipe's own schedule) — and an EPS-MoE
style fixed-granularity expert pipeline. Each helper returns a ``Plan``,
so through ``repro.sched`` every baseline is *runnable* on the DEP
executor, not only analytic.

Since the task-graph IR (``repro.core.taskgraph``) every baseline is an
*alternate lowering* of the same IR rather than a separate simulator:
naive/PPPipe lower with ``shared_blocks_a2e=True`` (dispatch waits on
the shared expert) and the EPS pipeline is an AASS lowering with a fixed
r2 — ``simulate_naive``/``simulate_pppipe``/``simulate_dep`` are thin
wrappers over ``taskgraph.lower`` + ``taskgraph.schedule``. The returned
plans carry the graph-derived per-primitive ``breakdown`` tags like
solver plans do."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from repro_torch.core.analytic import StageTimes
from repro_torch.core.perf_model import StageModels
from repro_torch.core.simulator import (SimResult, simulate_dep, simulate_naive,
                                  simulate_pppipe)
from repro_torch.core.solver import Plan, get_max_r1, max_r2


def _tagged(plan: Plan, res: SimResult) -> Plan:
    """Attach the lowered graph's per-primitive cost split to a baseline
    plan (normalized to the simulated makespan, same as solver plans)."""
    if res.scheduled is None:
        return plan
    return replace(plan, breakdown=res.scheduled.breakdown()
                   .normalized_to(plan.makespan))


def naive_plan(models: StageModels, T: int, mem_cap_samples: int,
               fixed_batch: Optional[int] = None) -> Plan:
    """Naive DEP: full mini-batch, strictly sequential."""
    m_a = fixed_batch if fixed_batch is not None else mem_cap_samples
    m_e = models.me_from_ma(m_a, 1)
    st = StageTimes.from_models(models, m_a, m_e)
    res = simulate_naive(st, T)
    tokens = m_a * models.cluster.ag * models.spec.S
    return _tagged(Plan(m_a=m_a, r1=1, m_e=m_e, r2=1, order="ASAS",
                        throughput=tokens / res.makespan,
                        makespan=res.makespan, objective="simulate"), res)


def pppipe_plan(models: StageModels, T: int, m_a: int, r1: int) -> Plan:
    """PPPipe with a given (m_a, r1): r2 = 1, shared blocks a2e."""
    m_e = models.me_from_ma(m_a, 1)
    st = StageTimes.from_models(models, m_a, m_e)
    res = simulate_pppipe(st, T, r1)
    tokens = r1 * m_a * models.cluster.ag * models.spec.S
    return _tagged(Plan(m_a=m_a, r1=r1, m_e=m_e, r2=1, order="ASAS",
                        throughput=tokens / res.makespan,
                        makespan=res.makespan, objective="simulate"), res)


def eps_pipeline_plan(models: StageModels, T: int, m_a: int,
                      r2: int = 4) -> Plan:
    """EPS-MoE-style expert pipeline: the whole mini-batch at once (r1 = 1)
    with the expert capacity split into a *fixed* number of chunks — the
    pipeline granularity is a hyper-parameter, not solved per shape. ``r2``
    is clipped to keep >= 1 token per expert per chunk."""
    r2 = max(1, min(r2, max_r2(models, m_a, cap=r2)))
    m_e = models.me_from_ma(m_a, r2)
    st = StageTimes.from_models(models, m_a, m_e)
    res = simulate_dep(st, T, 1, r2, order="AASS")
    tokens = m_a * models.cluster.ag * models.spec.S
    return _tagged(Plan(m_a=m_a, r1=1, m_e=m_e, r2=r2, order="AASS",
                        throughput=tokens / res.makespan,
                        makespan=res.makespan, objective="simulate"), res)


def best_pppipe(models: StageModels, T: int, mem_cap_samples: int,
                r1_cap: int = 64,
                fixed_batch: Optional[int] = None) -> Plan:
    """Best-configured PPPipe: exhaustive search over (m_a, r1) under the
    same memory constraint FinDEP gets. This is the paper's comparison
    point ("PPPipe with optimal ep, dp, m_a and r1 settings")."""
    best: Optional[Plan] = None
    for m_a in range(1, mem_cap_samples + 1):
        if fixed_batch is not None:
            if fixed_batch % m_a:
                continue
            r1_list = [fixed_batch // m_a]
        else:
            r1_list = range(1, get_max_r1(m_a, mem_cap_samples, r1_cap) + 1)
        for r1 in r1_list:
            if r1 == 0 or r1 > r1_cap:
                continue
            p = pppipe_plan(models, T, m_a, r1)
            if best is None or p.throughput > best.throughput:
                best = p
    assert best is not None
    return best
