"""A copy of ``repro.sched.policy``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Pluggable scheduling policies: one interface, every schedule family.

A ``SchedulePolicy`` maps an observed execution shape — (phase, sequence
bucket, per-device batch), or for decode an ``OccupancySummary`` of the
real live-slot composition — to a fully-specified ``Plan`` (m_a, r1, r2,
order). The serving engine, the DEP executor, the benchmarks and the
examples all consume schedules through this one surface, so the paper's
baselines are runnable systems rather than analytic curves:

  FinDEPPolicy        Algorithm 1 per shape (the paper's online phase)
  StaticPolicy        one frozen plan for every shape (the old
                      ExecutionContext.plan behavior)
  SequentialDEPPolicy r2 = 1 coarse schedule, MegaScale-Infer style:
                      micro-batch pipelining but no intra-layer chunking
  EPSPipelinePolicy   EPS-MoE style fixed-granularity expert pipeline:
                      whole batch, fixed r2 chosen offline

Policies that solve under a fixed arrived batch fall back to the
throughput-mode solve when the batch admits no feasible (m_a, r1)
decomposition under the memory cap (e.g. live-slot counts larger than the
per-device sample capacity).

A resolved ``Plan`` is consumed through the task-graph IR
(``repro.core.taskgraph``): the DEP executor walks
``plan.exec_program()`` (the r1-stream ``ExecProgram`` whose emission
order follows the scheduled start order; ``plan.exec_graph()`` is its
single-stream structural view), and solver/baseline plans carry a
graph-derived per-primitive ``breakdown`` that telemetry uses for drift
attribution and the interleaved emission uses for priority hints.
``FinDEPPlanner.lower``/``schedule_plan`` expose the full T-layer graph
behind a planner-backed policy's plans.
"""
from __future__ import annotations

from typing import Optional, Protocol, Tuple, runtime_checkable

from repro_torch.core.baselines import eps_pipeline_plan
from repro_torch.core.planner import FinDEPPlanner
from repro_torch.core.solver import Plan
from repro_torch.sched.occupancy import OccupancySummary


@runtime_checkable
class SchedulePolicy(Protocol):
    """Resolve an execution shape to a schedule ``Plan``.

    ``occupancy`` carries the decode batch's real composition (live slots
    + context-length histogram from the KV ledger); when given, it fills
    any shape argument the caller omitted. Shape-keyed calls
    (``resolve(phase, seq_bucket, batch)``) remain the prefill surface.
    ``skew`` (a quantized ``repro.placement.SkewSummary``) carries the
    observed routing skew so planner-backed policies solve under
    worst-rank EXP costs rather than the uniform assumption; policies
    without a cost model ignore it.
    """

    name: str

    def resolve(self, phase: str, seq_bucket: Optional[int] = None,
                batch_per_device: Optional[int] = None, *,
                occupancy: Optional[OccupancySummary] = None,
                skew=None) -> Plan:
        ...


def _shape(seq_bucket: Optional[int], batch_per_device: Optional[int],
           occupancy: Optional[OccupancySummary]
           ) -> Tuple[int, Optional[int]]:
    """The (seq, batch) a solver runs on: explicit arguments win; an
    occupancy summary fills in whatever was omitted."""
    if occupancy is not None:
        if seq_bucket is None:
            seq_bucket = occupancy.seq_bucket
        if batch_per_device is None:
            batch_per_device = occupancy.live
    if seq_bucket is None:
        raise ValueError("resolve() needs seq_bucket or occupancy")
    return int(seq_bucket), batch_per_device


def _solve_with_fallback(planner: FinDEPPlanner, seq_bucket: int,
                         batch_per_device: Optional[int],
                         r2_cap: Optional[int] = None, skew=None) -> Plan:
    try:
        return planner.plan(seq_bucket, batch_per_device, r2_cap=r2_cap,
                            skew=skew)
    except ValueError:
        # arrived batch infeasible under the memory cap: solver picks r1*m_a
        return planner.plan(seq_bucket, None, r2_cap=r2_cap, skew=skew)


class _PlannerBackedPolicy:
    """Shared refresh/recalibration hooks for policies that own a
    ``FinDEPPlanner`` (the surface ``repro.profiling`` retunes):

      invalidate()   drop the planner's solve memo so the next resolve
                     genuinely re-runs Algorithm 1 (PlanCache.refresh
                     calls this before re-resolving a drifted entry);
      reprofile(hw)  swap in a (re)calibrated HardwareProfile — also
                     drops the memo, since every cached plan was solved
                     under the old alpha-beta fit.
    """

    planner: FinDEPPlanner

    def invalidate(self) -> None:
        self.planner.clear_cache()

    def reprofile(self, hardware) -> None:
        self.planner.set_hardware(hardware)


def _is_decode_occupancy(phase: str, seq_bucket, batch_per_device,
                         occupancy) -> bool:
    """A decode resolve carrying only an occupancy summary solves under
    the decode cost model (``FinDEPPlanner.plan_for_occupancy``: one token
    per slot, attention linear in the histogram's mean context). Explicit
    shape arguments keep the prefill-style (seq_bucket, batch) solve."""
    return (phase == "decode" and occupancy is not None
            and seq_bucket is None and batch_per_device is None)


class FinDEPPolicy(_PlannerBackedPolicy):
    """The paper's online scheduler: Algorithm 1 re-solved per shape."""

    name = "findep"

    def __init__(self, planner: FinDEPPlanner):
        self.planner = planner

    def resolve(self, phase: str, seq_bucket: Optional[int] = None,
                batch_per_device: Optional[int] = None, *,
                occupancy: Optional[OccupancySummary] = None,
                skew=None) -> Plan:
        if _is_decode_occupancy(phase, seq_bucket, batch_per_device,
                                occupancy):
            return self.planner.plan_for_occupancy(occupancy, skew=skew)
        S, b = _shape(seq_bucket, batch_per_device, occupancy)
        return _solve_with_fallback(self.planner, S, b, skew=skew)


class StaticPolicy:
    """One plan for every shape — subsumes the old engine behavior of
    solving once at construction time for ``max_context``."""

    name = "static"

    def __init__(self, plan: Plan):
        self.plan = plan

    @classmethod
    def from_planner(cls, planner: FinDEPPlanner, seq_len: int,
                     batch_per_device: Optional[int] = None) -> "StaticPolicy":
        return cls(_solve_with_fallback(planner, seq_len, batch_per_device))

    def resolve(self, phase: str, seq_bucket: Optional[int] = None,
                batch_per_device: Optional[int] = None, *,
                occupancy: Optional[OccupancySummary] = None,
                skew=None) -> Plan:
        return self.plan


class SequentialDEPPolicy(_PlannerBackedPolicy):
    """MegaScale-Infer style coarse DEP: the solver still picks (m_a, r1)
    per shape, but r2 is pinned to 1 — each MoE layer's A2E, expert FFN and
    E2A run as whole-capacity stages with no intra-layer chunk overlap.
    Evaluated under the same objective as FinDEP, so a FinDEP solve with
    r2_cap=1 is makespan-identical by construction."""

    name = "sequential"

    def __init__(self, planner: FinDEPPlanner):
        self.planner = planner

    def resolve(self, phase: str, seq_bucket: Optional[int] = None,
                batch_per_device: Optional[int] = None, *,
                occupancy: Optional[OccupancySummary] = None,
                skew=None) -> Plan:
        if _is_decode_occupancy(phase, seq_bucket, batch_per_device,
                                occupancy):
            return self.planner.plan_for_occupancy(occupancy, r2_cap=1,
                                                   skew=skew)
        S, b = _shape(seq_bucket, batch_per_device, occupancy)
        return _solve_with_fallback(self.planner, S, b, r2_cap=1, skew=skew)


class EPSPipelinePolicy(_PlannerBackedPolicy):
    """EPS-MoE style fixed-granularity pipeline: no online solve at all —
    the whole arrived batch goes through at once (r1 = 1) and the expert
    capacity is split into a fixed ``granularity`` chunks."""

    name = "eps"

    def __init__(self, planner: FinDEPPlanner, granularity: int = 4):
        self.planner = planner
        self.granularity = granularity

    def resolve(self, phase: str, seq_bucket: Optional[int] = None,
                batch_per_device: Optional[int] = None, *,
                occupancy: Optional[OccupancySummary] = None,
                skew=None) -> Plan:
        seq_bucket, batch_per_device = _shape(seq_bucket, batch_per_device,
                                              occupancy)
        cap = self.planner.cfg.mem_cap_samples
        m_a = min(batch_per_device or cap, cap)
        models = self.planner.stage_models(seq_bucket)
        return eps_pipeline_plan(models, self.planner.num_moe_layers(),
                                 m_a, r2=self.granularity)


POLICIES = ("findep", "static", "sequential", "eps")


def make_policy(name: str, planner: FinDEPPlanner, *,
                static_seq_len: Optional[int] = None,
                eps_granularity: int = 4) -> SchedulePolicy:
    """Build a policy by CLI name. ``static`` solves once for
    ``static_seq_len`` (required) and never re-plans."""
    if name == "findep":
        return FinDEPPolicy(planner)
    if name == "sequential":
        return SequentialDEPPolicy(planner)
    if name == "eps":
        return EPSPipelinePolicy(planner, granularity=eps_granularity)
    if name == "static":
        if static_seq_len is None:
            raise ValueError("StaticPolicy needs static_seq_len (the shape "
                             "it is tuned for)")
        return StaticPolicy.from_planner(planner, static_seq_len)
    raise ValueError(f"unknown policy {name!r}; choose from {POLICIES}")
