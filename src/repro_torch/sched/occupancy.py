"""Occupancy summaries: the decode-side scheduling shape (a copy of
``repro.sched.occupancy``, kept in the port so it imports nothing of the
JAX package).

``OccupancySummary`` is the live decode composition backed by the
``KVCacheManager`` ledger: the number of live slots plus a histogram of
their context lengths, bucketed so recurring compositions compare equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Tuple

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def bucket_length(n: int, buckets: Tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    """Round ``n`` up to a scheduling bucket (multiples of the largest
    bucket beyond the table)."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


@dataclass(frozen=True, order=True)
class OccupancySummary:
    """Live decode-batch composition: ``live`` slots whose context lengths
    fall into ``hist`` — a sorted tuple of (context_bucket, num_slots)."""

    live: int
    hist: Tuple[Tuple[int, int], ...] = ()
    #: paged-KV pool pressure; 0.0 under the dense layout. Excluded from
    #: eq/hash/order.
    block_pressure: float = field(default=0.0, compare=False)

    @classmethod
    def from_lengths(cls, lengths: Iterable[int], *, max_bucket: int = 0,
                     block_pressure: float = 0.0) -> "OccupancySummary":
        counts: dict = {}
        n = 0
        for length in lengths:
            b = bucket_length(max(int(length), 1))
            if max_bucket:
                b = min(b, max_bucket)
            counts[b] = counts.get(b, 0) + 1
            n += 1
        return cls(live=n, hist=tuple(sorted(counts.items())),
                   block_pressure=block_pressure)

    @property
    def tokens(self) -> int:
        """Upper bound on live context tokens (sum of bucketed lengths)."""
        return sum(b * c for b, c in self.hist)

    @property
    def max_bucket(self) -> int:
        return max((b for b, _ in self.hist), default=bucket_length(1))

    @property
    def mean_context(self) -> float:
        if not self.live:
            return 0.0
        return self.tokens / self.live

    @property
    def std_context(self) -> float:
        if not self.live:
            return 0.0
        m = self.mean_context
        var = sum(c * (b - m) ** 2 for b, c in self.hist) / self.live
        return math.sqrt(max(var, 0.0))

    @property
    def seq_bucket(self) -> int:
        n = sum(c for _, c in self.hist)
        if n == 0:
            return bucket_length(1)
        return bucket_length(math.ceil(self.tokens / n))

    def __repr__(self) -> str:
        h = ",".join(f"{b}:{c}" for b, c in self.hist)
        return f"Occupancy(live={self.live}, hist=[{h}])"
