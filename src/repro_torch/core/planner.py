"""A copy of ``repro.core.planner``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

FinDEP online pipeline (paper Fig. 6).

Offline phase: pick model + (ag, eg); microbenchmark the hardware to fit the
alpha-beta models (or use an analytic HardwareProfile); cache StageModels
per sequence length is NOT possible (S enters the coefficients), so we cache
the HardwareProfile + DepModelSpec template and instantiate per request.

Online phase: on batch arrival (known batch size + sequence length), run
Algorithm 1 (< 1 s; typically < 10 ms here) to produce the Plan that the
executor (repro.core.dep) materializes as a chunked shard_map program.

Serving stacks should not call the planner directly per step: wrap it in a
``repro.sched.FinDEPPolicy`` behind a ``repro.sched.PlanCache`` so repeated
shapes hit the memo and only genuine shape changes pay a solve.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import DepClusterConfig, ModelConfig
from repro_torch.core.analytic import StageTimes
from repro_torch.core.perf_model import (DepModelSpec, HardwareProfile, StageModels,
                                   build_stage_models)
from repro_torch.core.solver import Plan, SolverStats, solve
from repro_torch.core.taskgraph import (LoweringSpec, ScheduleResult, TaskCosts,
                                  TaskGraph, lower, schedule)


@dataclass
class PlannerConfig:
    mem_cap_samples: int = 64      # AG per-device sample capacity
    objective: str = "hybrid"
    r1_cap: int = 64
    r2_cap: int = 64
    T_override: Optional[int] = None   # MoE depth override (paper tables
                                       # use reduced-depth variants)


class FinDEPPlanner:
    """Offline-calibrated, online-solving planner."""

    def __init__(self, model_cfg: ModelConfig, cluster: DepClusterConfig,
                 hardware: HardwareProfile,
                 planner_cfg: Optional[PlannerConfig] = None,
                 validate: bool = False):
        assert model_cfg.is_moe, "FinDEP plans MoE models"
        self.model_cfg = model_cfg
        self.cluster = cluster
        self.hardware = hardware
        self.cfg = planner_cfg or PlannerConfig()
        #: opt-in static verification: every fresh solve's full lowering
        #: is run through ``repro.analysis.graphcheck`` (structure,
        #: capacity, deadlock-freedom, race-free schedule under the
        #: measured stage costs) before the plan is memoized; violations
        #: raise ``repro.analysis.AnalysisError``.
        self.validate = validate
        # (seq_len, batch_per_device, r2_cap, decode_context) -> Plan
        self._cache: Dict[Tuple, Plan] = {}
        self.last_solve_time: float = 0.0
        self.last_stats: Optional[SolverStats] = None
        self.solve_count: int = 0
        self.total_solve_time: float = 0.0

    def num_moe_layers(self) -> int:
        """T in the paper's notation: MoE layers per forward pass."""
        return self.cfg.T_override or len(self.model_cfg.moe_layer_indices())

    def stage_models(self, seq_len: int,
                     decode_context: Optional[float] = None,
                     skew=None) -> StageModels:
        spec = DepModelSpec.from_model_config(self.model_cfg, seq_len)
        if self.cfg.T_override is not None:
            spec = dataclasses.replace(spec, T=self.cfg.T_override)
        if decode_context:
            spec = dataclasses.replace(spec,
                                       decode_context=float(decode_context))
        return build_stage_models(self.hardware, spec, self.cluster,
                                  skew=skew)

    def plan(self, seq_len: int, batch_per_device: Optional[int] = None,
             r2_cap: Optional[int] = None,
             decode_context: Optional[float] = None, skew=None) -> Plan:
        """Online solve for an arrived batch shape. ``batch_per_device``
        None => offline throughput mode (batch chosen by the solver).
        ``r2_cap`` overrides the configured chunking cap — r2_cap=1 yields
        the coarse sequential-DEP schedule under the same objective.
        ``decode_context`` switches the attention term to the decode model
        (one query per token over that many cached positions).
        ``skew`` (a quantized ``repro.placement.SkewSummary``) makes the
        per-stage cost models reflect observed routing skew; it joins the
        solve memo key, so recurring skew regimes hit the memo and only a
        regime shift (different quantized summary) pays a re-solve."""
        r2_cap = self.cfg.r2_cap if r2_cap is None else r2_cap
        if skew is not None and getattr(skew, "is_uniform", False):
            skew = None                 # uniform == legacy key, legacy cost
        key = (seq_len, batch_per_device, r2_cap, decode_context)
        if skew is not None:
            key = key + (skew,)
        if key in self._cache:
            return self._cache[key]
        models = self.stage_models(seq_len, decode_context=decode_context,
                                   skew=skew)
        T = self.num_moe_layers()
        t0 = time.perf_counter()
        plan, stats = solve(models, T, self.cfg.mem_cap_samples,
                            objective=self.cfg.objective,
                            r1_cap=self.cfg.r1_cap, r2_cap=r2_cap,
                            fixed_batch=batch_per_device)
        self.last_solve_time = time.perf_counter() - t0
        self.last_stats = stats
        self.solve_count += 1
        self.total_solve_time += self.last_solve_time
        if self.validate:
            self._validate_plan(plan, models)
        self._cache[key] = plan
        return plan

    def _validate_plan(self, plan: Plan, models: StageModels) -> None:
        """Static-verify a freshly solved plan's full lowering (see
        ``validate``): graphcheck under the measured stage costs, raising
        ``AnalysisError`` on any violation. Imported lazily — the
        analysis package imports this module for its sweep."""
        from repro_torch.analysis import AnalysisError
        from repro_torch.analysis.graphcheck import check_graph
        st = StageTimes.from_models(models, plan.m_a, plan.m_e)
        graph = self.lower(plan, hot_experts=1 if st.t_rep > 0.0 else 0)
        violations = check_graph(graph, TaskCosts.from_stage_times(st))
        if violations:
            raise AnalysisError(violations)

    def lower(self, plan: Plan, shared_blocks_a2e: bool = False,
              hot_experts: int = 0, placement_epoch: int = 0) -> TaskGraph:
        """Lower ``plan`` to its full T-layer ``TaskGraph`` under this
        planner's model (the same lowering the simulator schedules and
        the executor walks per layer). ``hot_experts``/``placement_epoch``
        carry the active expert placement into the graph (REP tasks +
        epoch identity); the defaults reproduce the unreplicated graph."""
        has_shared = (self.model_cfg.moe is not None
                      and self.model_cfg.moe.num_shared_experts > 0)
        return lower(plan, LoweringSpec(T=self.num_moe_layers(),
                                        has_shared=has_shared,
                                        shared_blocks_a2e=shared_blocks_a2e),
                     hot_experts=hot_experts,
                     placement_epoch=placement_epoch)

    def schedule_plan(self, plan: Plan, seq_len: int,
                      decode_context: Optional[float] = None,
                      shared_blocks_a2e: bool = False,
                      skew=None) -> ScheduleResult:
        """Lower ``plan`` and schedule it under this planner's measured
        stage models for ``seq_len`` — the modeled per-task timeline of
        one executed step (benchmarks/plan_trace renders this as a
        Gantt; Table 7 derives exposed-communication time from it).
        With ``skew`` the timeline includes the REP lane segment and the
        kappa/(1-rho)-scaled EXP/comm task times."""
        models = self.stage_models(seq_len, decode_context=decode_context,
                                   skew=skew)
        st = StageTimes.from_models(models, plan.m_a, plan.m_e)
        hot = 1 if st.t_rep > 0.0 else 0
        return schedule(self.lower(plan, shared_blocks_a2e=shared_blocks_a2e,
                                   hot_experts=hot),
                        TaskCosts.from_stage_times(st))

    def set_hardware(self, hardware: HardwareProfile) -> None:
        """Swap in a (re)calibrated profile. Every memoized plan was solved
        under the old alpha-beta models, so the memo is dropped — the next
        ``plan()`` per shape re-runs Algorithm 1 on the new fit."""
        self.hardware = hardware
        self.clear_cache()

    def plan_for_occupancy(self, occupancy, r2_cap: Optional[int] = None,
                           skew=None) -> Plan:
        """Decode solve on a KV-ledger ``OccupancySummary``: one token per
        live slot (S = 1 — a decode step routes exactly one token per
        sample into the MoE), attention LINEAR in the histogram's mean
        context rather than quadratic in a context *bucket*. The mean is
        widened by the standard error (sigma / sqrt(live)) so the modeled
        per-device context is a conservative estimate of the realized
        per-device mean when slots scatter across AG devices. The solved
        makespan is therefore the cost of ONE decode step over the real
        composition — directly comparable to the StepTimer's measured
        decode wall time, where the old (seq_bucket, live) prefill-style
        projection over-predicted by orders of magnitude."""
        ctx = occupancy.mean_context
        if occupancy.live:
            ctx += occupancy.std_context / math.sqrt(occupancy.live)
        # quantize to keep the solve-memo key cardinality bounded: the
        # sigma widening makes ctx near-continuous, and every distinct
        # float would otherwise pin a permanent entry in self._cache
        ctx = float(max(math.ceil(ctx / 16.0), 1) * 16)
        try:
            return self.plan(1, occupancy.live or None, r2_cap=r2_cap,
                             decode_context=ctx, skew=skew)
        except ValueError:
            # live count infeasible under the memory cap: solver's batch
            return self.plan(1, None, r2_cap=r2_cap, decode_context=ctx,
                             skew=skew)

    def clear_cache(self) -> None:
        self._cache.clear()
