"""Plan-cache misses in the window (``PlanCache.stats.misses``): each a
host-side solve of the FinDEP planner, keyed by the prefill shape or
the decode occupancy."""


def read(w):
    return float(w.delta("plan_misses"))
