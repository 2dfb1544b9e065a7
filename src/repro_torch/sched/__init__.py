"""Scheduling shapes of the port (the planner and policies come later)."""
from repro_torch.sched.occupancy import (DEFAULT_BUCKETS, OccupancySummary,
                                         bucket_length)

__all__ = ["DEFAULT_BUCKETS", "OccupancySummary", "bucket_length"]
