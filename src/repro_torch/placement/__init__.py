"""A copy of ``repro.placement``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Expert placement subsystem: load telemetry, hot-expert replication,
and skew-aware placement — the observe -> place -> plan loop for
experts.

    ExpertLoadTracker   per-layer [E] EWMA of gate token loads
    Placement           expert -> rank map + replica set + epoch
    rebalance           greedy LPT + top-k hot replication
    SkewSummary         quantized skew fingerprint for plan-cache keys
"""
from repro_torch.placement.placement import (Placement, max_rank_load,
                                       modeled_exp_time, rank_loads,
                                       rebalance)
from repro_torch.placement.tracker import (UNIFORM_SKEW, ExpertLoadTracker,
                                     SkewSummary, capacity_scale, zipf_loads)

__all__ = [
    "ExpertLoadTracker",
    "Placement",
    "SkewSummary",
    "UNIFORM_SKEW",
    "capacity_scale",
    "max_rank_load",
    "modeled_exp_time",
    "rank_loads",
    "rebalance",
    "zipf_loads",
]
