"""A copy of ``repro.core.simulator``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Exact discrete-event simulation of the DEP 4-resource pipeline, as a
thin wrapper over the task-graph IR (``repro.core.taskgraph``).

Resources (paper Section 3.2): AG compute, A2E link, EG compute, E2A link.
Tasks per layer t:  A(t,i) and S(t,i) for micro-batch i < r1 on AG;
a2e(t,i,j) / E(t,i,j) / e2a(t,i,j) for chunk j < r2 on link/EG/link.

Precedence constraints implement Eq. 5 rules 6-10:
  * S(t,i)        >= end A(t,i)
  * a2e(t,i,j)    >= end A(t,i)           (FinDEP: shared does NOT block a2e)
                  >= end S(t,i)           (PPPipe/naive: it does)
  * E(t,i,j)      >= end a2e(t,i,j)
  * e2a(t,i,j)    >= end E(t,i,j)
  * A(t+1,i)      >= max(end e2a(t,i,r2-1), end S(t,i))
Rules 1-5 (mutual exclusion per resource) hold because each resource
processes its tasks sequentially in a fixed order: AG in the policy order
(ASAS / AASS), links and EG FIFO by (t, i, j).

These rules ARE the lowering rules of ``taskgraph.lower``; this module
only (a) maps the legacy ``(st, T, r1, r2, order)`` signature onto a
lowering + ``taskgraph.schedule`` call and (b) keeps the baseline entry
points -- naive DEP and PPPipe are alternate lowerings
(``shared_blocks_a2e=True``) of the same IR, not separate simulators.
The generic list scheduler is exact and O(#tasks) because every
resource's service order is fixed by the graph's emission order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.analytic import ORDER_ASAS, StageTimes
from repro_torch.core.taskgraph import (ATTN, E2A, SHARED, ScheduleResult,
                                  TaskCosts, _lower_structure, schedule,
                                  schedule_makespan)

Interval = Tuple[float, float]


@dataclass
class SimResult:
    makespan: float
    busy: Dict[str, float]                    # summed busy time per resource
    intervals: Optional[Dict[str, List[Interval]]] = None
    # completion views used by tests:
    last_e2a_end: float = 0.0
    last_shared_end: float = 0.0
    #: the underlying per-task schedule (graph, starts, ends) -- the same
    #: structure the executor walks and telemetry tags against
    scheduled: Optional[ScheduleResult] = None

    def utilization(self, resource: str) -> float:
        return self.busy[resource] / self.makespan if self.makespan else 0.0


def simulate_graph(graph, costs: TaskCosts,
                   record_intervals: bool = False) -> SimResult:
    """Schedule ANY lowered ``TaskGraph`` and wrap it as a ``SimResult``.
    The one scheduling code path behind every ``simulate_*`` entry."""
    res = schedule(graph, costs)
    # lanes serve FIFO, so a kind's last-scheduled end IS its max end,
    # and the last ATTN/SHARED/E2A tasks sit in the last layer
    last_shared = res.last_end(SHARED if graph.has_shared else ATTN)
    return SimResult(makespan=res.makespan, busy=res.busy,
                     intervals=res.intervals if record_intervals else None,
                     last_e2a_end=res.last_end(E2A),
                     last_shared_end=last_shared,
                     scheduled=res)


def _hot_experts_for(st: StageTimes) -> int:
    """Structural REP flag from the stage times: a positive t_rep means
    the models were built under a replicating placement, so the lowering
    emits the REP task (mirrors how ``has_shared`` follows t_s)."""
    return 1 if getattr(st, "t_rep", 0.0) > 0.0 else 0


def simulate_dep(st: StageTimes, T: int, r1: int, r2: int,
                 order: str = ORDER_ASAS,
                 shared_blocks_a2e: bool = False,
                 record_intervals: bool = False) -> SimResult:
    """Simulate the full T-layer pipeline; returns exact makespan."""
    graph = _lower_structure(T=T, r1=r1, r2=r2, order=order,
                             has_shared=st.t_s > 0.0,
                             shared_blocks_a2e=shared_blocks_a2e,
                             hot_experts=_hot_experts_for(st))
    return simulate_graph(graph, TaskCosts.from_stage_times(st),
                          record_intervals=record_intervals)


def simulate_makespan(st: StageTimes, T: int, r1: int, r2: int,
                      order: str = ORDER_ASAS,
                      shared_blocks_a2e: bool = False) -> float:
    """Makespan of ``simulate_dep`` without the per-task schedule — the
    solver's simulate objective evaluates hundreds of candidate plans and
    only reads the makespan, so it takes the vectorized lane recurrence
    (``taskgraph.schedule_makespan``) instead of the generic list
    scheduler. Identical to ``simulate_dep(...).makespan`` up to float
    rounding (parity-locked by test)."""
    graph = _lower_structure(T=T, r1=r1, r2=r2, order=order,
                             has_shared=st.t_s > 0.0,
                             shared_blocks_a2e=shared_blocks_a2e,
                             hot_experts=_hot_experts_for(st))
    return schedule_makespan(graph, TaskCosts.from_stage_times(st))


# ---------------------------------------------------------------------------
# Baselines: alternate lowerings of the same IR
# ---------------------------------------------------------------------------


def simulate_naive(st: StageTimes, T: int,
                   record_intervals: bool = False) -> SimResult:
    """Naive DEP: one mini-batch, fully sequential (r1 = r2 = 1, shared
    blocks a2e)."""
    return simulate_dep(st, T, r1=1, r2=1, order=ORDER_ASAS,
                        shared_blocks_a2e=True,
                        record_intervals=record_intervals)


def simulate_pppipe(st: StageTimes, T: int, r1: int,
                    record_intervals: bool = False) -> SimResult:
    """PPPipe (MegaScale-Infer): r1 micro-batches, no token chunking,
    shared expert treated as part of attention (blocks a2e)."""
    return simulate_dep(st, T, r1=r1, r2=1, order=ORDER_ASAS,
                        shared_blocks_a2e=True,
                        record_intervals=record_intervals)


# ---------------------------------------------------------------------------
# Interval analytics (Table 7: non-overlapped communication time)
# ---------------------------------------------------------------------------


def _union(iv: List[Interval]) -> List[Interval]:
    if not iv:
        return []
    iv = sorted(iv)
    out = [iv[0]]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """a \\ b for sorted disjoint interval lists."""
    out = []
    bi = 0
    for s, e in a:
        cur = s
        while bi < len(b) and b[bi][1] <= cur:
            bi += 1
        k = bi
        while k < len(b) and b[k][0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def total_len(iv: List[Interval]) -> float:
    return sum(e - s for s, e in iv)


def non_overlapped_comm_time(res) -> float:
    """Time when a link (A2E or E2A) is busy but neither AG nor EG
    computes, for a ``SimResult`` (simulate with record_intervals=True)
    or directly for a ``taskgraph.ScheduleResult`` -- the Table 7
    exposed-communication metric computed from the lowered graph's
    scheduled intervals.
    """
    intervals = res.intervals
    assert intervals is not None, "simulate with record_intervals=True"
    comm = _union(intervals["A2E"] + intervals["E2A"])
    compute = _union(intervals["AG"] + intervals["EG"])
    return total_len(_subtract(comm, compute))
