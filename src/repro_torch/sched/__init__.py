"""Scheduling layer of the port (a copy of ``repro.sched``): pluggable
policies and the per-shape plan cache.

``SchedulePolicy.resolve(phase, seq_bucket, batch_per_device,
occupancy=...) -> Plan`` is the one interface through which the engine
and the DEP executor obtain schedules; ``PlanCache`` memoizes resolved
plans per shape (prefill buckets) or per ``OccupancySummary`` (decode
solved on the live-slot composition).
"""
from repro_torch.sched.cache import (EntryMeta, PlanCache, PlanCacheStats,
                                     PlanKey)
from repro_torch.sched.occupancy import (DEFAULT_BUCKETS, OccupancySummary,
                                         bucket_length)
from repro_torch.sched.policy import (POLICIES, EPSPipelinePolicy,
                                      FinDEPPolicy, SchedulePolicy,
                                      SequentialDEPPolicy, StaticPolicy,
                                      make_policy)

__all__ = [
    "PlanCache", "PlanCacheStats", "PlanKey", "EntryMeta", "SchedulePolicy",
    "FinDEPPolicy", "StaticPolicy", "SequentialDEPPolicy",
    "EPSPipelinePolicy", "POLICIES", "make_policy",
    "OccupancySummary", "DEFAULT_BUCKETS", "bucket_length",
]
