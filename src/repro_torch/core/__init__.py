"""A copy of ``repro.core``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

FinDEP core: performance models, analytic makespan, the task-graph
execution IR with its exact scheduler/simulator, Algorithm-1 solver,
baselines, and the online planner."""
from repro_torch.core.analytic import (ORDER_AASS, ORDER_ASAS, ORDERS, StageTimes,
                                 makespan_closed_form, makespan_naive,
                                 makespan_pppipe, throughput, xyfg)
from repro_torch.core.baselines import (best_pppipe, eps_pipeline_plan, naive_plan,
                                  pppipe_plan)
from repro_torch.core.taskgraph import (CostBreakdown, ExecProgram, LoweringSpec,
                                  ScheduleResult, Task, TaskCosts, TaskGraph,
                                  ascii_gantt, lower, lower_exec, schedule,
                                  stream_major_order, stream_serial_deps)
from repro_torch.core.perf_model import (PROFILES, TPU_V5E, PAPER_A6000, AlphaBeta,
                                   DepModelSpec, HardwareProfile, StageModels,
                                   build_stage_models, calibrated_stage_models,
                                   fit_alpha_beta, fit_profile, get_profile,
                                   register_profile)
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig
from repro_torch.core.simulator import (SimResult, non_overlapped_comm_time,
                                  simulate_dep, simulate_naive,
                                  simulate_pppipe)
from repro_torch.core.solver import (Plan, SolverStats, solve,
                               solve_brute_force, solve_r2)

__all__ = [
    "ORDER_AASS", "ORDER_ASAS", "ORDERS", "StageTimes",
    "makespan_closed_form", "makespan_naive", "makespan_pppipe",
    "throughput", "xyfg", "best_pppipe", "eps_pipeline_plan", "naive_plan",
    "pppipe_plan",
    "PROFILES", "TPU_V5E", "PAPER_A6000", "AlphaBeta", "DepModelSpec",
    "HardwareProfile", "StageModels", "build_stage_models",
    "calibrated_stage_models", "fit_alpha_beta", "fit_profile",
    "get_profile", "register_profile",
    "FinDEPPlanner", "PlannerConfig", "SimResult",
    "non_overlapped_comm_time", "simulate_dep", "simulate_naive",
    "simulate_pppipe", "Plan", "SolverStats", "solve",
    "solve_brute_force", "solve_r2",
    "Task", "TaskGraph", "TaskCosts", "CostBreakdown", "ExecProgram",
    "LoweringSpec", "ScheduleResult", "lower", "lower_exec", "schedule",
    "ascii_gantt", "stream_major_order", "stream_serial_deps",
]
