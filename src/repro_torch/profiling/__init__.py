"""Measured cost models of the port (a counterpart of
``repro.profiling``): microbench calibration on the port's own kernels,
profile persistence, runtime telemetry, and drift-triggered plan refresh.

The paper fits its alpha-beta cost models on measured microbenchmarks
(Fig. 7, R^2 > 0.994); this package closes that loop for the port:

  microbench   measure the four primitives (GEMM, attention, decode,
               all_to_all) on THIS card and expert group in perf_model
               units
  store        persist fitted HardwareProfiles keyed by (device kind,
               mesh shape, dtype) so calibration runs once per host
  telemetry    StepTimer: measured prefill/decode wall-times vs each
               plan's modeled makespan -> residuals
  refresh      DriftMonitor + PlanRefresher: a residual breach
               invalidates one PlanCache entry and re-solves it on a
               worker thread while the stale plan keeps serving;
               PeriodicRecalibrator re-runs the microbenchmarks when the
               stored profile goes stale (cron-style, off-path)
  attribution  per-primitive drift attribution: fit gemm/attn/comm scale
               factors from task-graph-tagged residuals so a comm
               slowdown retunes alpha_c/beta_c without inflating the
               compute terms
"""
from repro_torch.profiling.microbench import (ATTN_SWEEP, ATTN_SWEEP_FAST,
                                              CARD_SWEEPS, COMM_SWEEP_BYTES,
                                              COMM_SWEEP_BYTES_FAST,
                                              CalibrationResult,
                                              DECODE_SWEEP, DECODE_SWEEP_FAST,
                                              GEMM_SWEEP, GEMM_SWEEP_FAST,
                                              MICROBENCH_KINDS,
                                              MicrobenchSamples, Sweeps,
                                              calibrate, measure_all_to_all,
                                              measure_attention,
                                              measure_decode_attention,
                                              measure_gemm,
                                              run_microbenchmarks,
                                              sweeps_for, time_fn)
from repro_torch.profiling.attribution import (PRIMITIVES, attribution_rows,
                                               fit_primitive_scales)
from repro_torch.profiling.refresh import (DriftMonitor, DriftStats,
                                           PeriodicRecalibrator,
                                           PlanRefresher, planner_of,
                                           rescale_policy_hardware,
                                           rescale_policy_hardware_by)
from repro_torch.profiling.store import (DEFAULT_STORE_DIR, ProfileKey,
                                         ProfileStore, SCHEMA_VERSION,
                                         StoredProfile)
from repro_torch.profiling.telemetry import KeyStats, PhaseStats, StepTimer

__all__ = [
    "MicrobenchSamples", "CalibrationResult", "calibrate",
    "measure_gemm", "measure_attention", "measure_all_to_all",
    "measure_decode_attention", "run_microbenchmarks", "time_fn",
    "GEMM_SWEEP", "GEMM_SWEEP_FAST", "ATTN_SWEEP", "ATTN_SWEEP_FAST",
    "COMM_SWEEP_BYTES", "COMM_SWEEP_BYTES_FAST",
    "DECODE_SWEEP", "DECODE_SWEEP_FAST", "MICROBENCH_KINDS",
    "ProfileKey", "ProfileStore", "StoredProfile", "SCHEMA_VERSION",
    "DEFAULT_STORE_DIR",
    "StepTimer", "PhaseStats", "KeyStats",
    "DriftMonitor", "DriftStats", "PlanRefresher", "PeriodicRecalibrator",
    "planner_of", "rescale_policy_hardware", "rescale_policy_hardware_by",
    "PRIMITIVES", "attribution_rows", "fit_primitive_scales",
]
