"""A copy of ``repro.sched.cache``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Per-shape plan cache for the scheduling layer.

The paper's online phase re-solves (m_a, r1, r2, order) on every batch
arrival (Fig. 6); in a serving loop the same execution shape recurs
thousands of times, so the engine memoizes resolved ``Plan``s here.
A hit costs a dict lookup (~100 ns); a miss invokes the policy's solver
(Algorithm 1, typically < 10 ms) and records its latency, so decode steps
pay ~zero scheduling cost while genuine shape changes still re-solve.

Two key spaces coexist:

  * shape keys ``(phase, seq_bucket, batch_per_device)`` — the prefill
    surface (a padded bucket IS the executed shape) and the legacy decode
    proxy;
  * occupancy keys ``(phase, OccupancySummary)`` — decode plans solved on
    the real live-slot composition from the KV ledger.

Policies that predate the ``occupancy=`` argument are still served: the
cache detects the old ``resolve(phase, seq_bucket, batch)`` signature and
falls back to it (with a DeprecationWarning) by projecting the summary
onto its (seq_bucket, live) shape.

Beyond memoization the cache is the refresh surface of the profiling
subsystem (``repro.profiling``):

  * ``capacity=`` bounds the entry count with cost-aware eviction — the
    victim is the entry with the lowest hit-count x solve-latency score
    (cheap-to-resolve, rarely-reused shapes go first), LRU tie-break;
  * ``invalidate(key)`` drops one entry so the next lookup re-solves;
  * ``refresh(key)`` re-resolves one entry IN PLACE: the stale plan keeps
    serving every lookup until the replacement is computed, which is what
    lets drift-triggered re-solves run off the critical path.
"""
from __future__ import annotations

import inspect
import time
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

from repro_torch.core.solver import Plan
from repro_torch.placement import SkewSummary
from repro_torch.sched.occupancy import OccupancySummary

# ("prefill"|"decode"|custom, seq_bucket, batch_per_device) for shape keys,
# or (phase, OccupancySummary) for occupancy-resolved decode plans. Either
# form is suffixed with a SkewSummary when the engine resolves under
# observed non-uniform routing skew — the summary carries the placement
# epoch, so a re-balance (epoch bump) keys NEW entries and the engine
# invalidates the stale ones.
PlanKey = Union[Tuple[str, int, Optional[int]],
                Tuple[str, OccupancySummary],
                Tuple[str, int, Optional[int], SkewSummary],
                Tuple[str, OccupancySummary, SkewSummary]]


@dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    solve_time_total: float = 0.0   # seconds spent inside policy.resolve
    solve_time_last: float = 0.0
    evictions: int = 0              # capacity-pressure removals
    invalidations: int = 0          # explicit invalidate() calls
    refreshes: int = 0              # in-place re-solves (drift refresh)

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self):
        return dict(hits=self.hits, misses=self.misses,
                    hit_rate=self.hit_rate,
                    solve_time_total=self.solve_time_total,
                    solve_time_last=self.solve_time_last,
                    evictions=self.evictions,
                    invalidations=self.invalidations,
                    refreshes=self.refreshes)


@dataclass
class EntryMeta:
    """Per-entry bookkeeping driving cost-aware eviction."""

    hits: int = 0
    solve_s: float = 0.0
    last_used: int = 0          # monotonic lookup tick (LRU tie-break)

    @property
    def score(self) -> float:
        """Cost-aware retention value: hit-count x solve-latency. An
        entry that was expensive to solve AND gets reused is worth
        keeping; either factor at zero makes it the cheapest victim."""
        return self.hits * self.solve_s


def _takes_kwarg(policy, kwarg: str) -> bool:
    try:
        return kwarg in inspect.signature(policy.resolve).parameters
    except (TypeError, ValueError):    # builtins / exotic callables
        return True


def _takes_occupancy(policy) -> bool:
    return _takes_kwarg(policy, "occupancy")


class PlanCache:
    """Memoizes ``policy.resolve`` per execution shape.

    The cache is the component that replaces the old static
    ``ExecutionContext.plan``: instead of one plan frozen at engine
    construction, every distinct execution shape owns one cached plan.

    Layering note: planner-backed policies keep their own memo inside
    ``FinDEPPlanner`` (keyed without ``phase``; relied on by offline
    callers). A miss here therefore means "the policy was consulted", not
    necessarily "Algorithm 1 ran" — ``solve_time_*`` records the actual
    resolve latency either way, and planner-level solves are counted in
    ``FinDEPPlanner.solve_count``.
    """

    def __init__(self, policy, capacity: Optional[int] = None):
        assert capacity is None or capacity >= 1
        self.policy = policy
        self.capacity = capacity
        self._plans: Dict[PlanKey, Plan] = {}
        self._meta: Dict[PlanKey, EntryMeta] = {}
        self._tick = 0
        self.stats = PlanCacheStats()
        self._occupancy_aware = _takes_occupancy(policy)
        self._skew_aware = _takes_kwarg(policy, "skew")

    @staticmethod
    def _key(phase: str, seq_bucket, batch_per_device, occupancy,
             skew=None) -> PlanKey:
        if occupancy is not None:
            key: Tuple = (phase, occupancy)
        elif seq_bucket is None:
            raise ValueError("PlanCache.get needs seq_bucket or occupancy")
        else:
            key = (phase, int(seq_bucket), batch_per_device)
        if skew is not None:
            key = key + (skew,)
        return key

    def get(self, phase: str, seq_bucket: Optional[int] = None,
            batch_per_device: Optional[int] = None, *,
            occupancy: Optional[OccupancySummary] = None,
            skew: Optional[SkewSummary] = None) -> Plan:
        if skew is not None and skew.is_uniform:
            skew = None         # uniform routing == the legacy key space
        key = self._key(phase, seq_bucket, batch_per_device, occupancy, skew)
        self._tick += 1
        plan = self._plans.get(key)
        if plan is not None:
            self.stats.hits += 1
            meta = self._meta.get(key)
            if meta is not None:
                meta.hits += 1
                meta.last_used = self._tick
            return plan
        t0 = time.perf_counter()
        plan = self._resolve(phase, seq_bucket, batch_per_device, occupancy,
                             skew)
        dt = time.perf_counter() - t0
        self.stats.misses += 1
        self.stats.solve_time_last = dt
        self.stats.solve_time_total += dt
        self._plans[key] = plan
        self._meta[key] = EntryMeta(solve_s=dt, last_used=self._tick)
        self._evict_over_capacity(keep=key)
        return plan

    def _evict_over_capacity(self, keep: PlanKey) -> None:
        if self.capacity is None:
            return
        while len(self._plans) > self.capacity:
            victim = min(
                (k for k in self._plans if k != keep),
                key=lambda k: (self._meta[k].score,
                               self._meta[k].last_used))
            del self._plans[victim]
            del self._meta[victim]
            self.stats.evictions += 1

    # ------------------------------------------------------------------
    # refresh hooks (repro.profiling.refresh drives these)
    # ------------------------------------------------------------------
    def invalidate(self, key: PlanKey) -> bool:
        """Drop one entry; the next lookup of this shape re-solves."""
        if self._plans.pop(key, None) is None:
            return False
        self._meta.pop(key, None)
        self.stats.invalidations += 1
        return True

    def refresh(self, key: PlanKey) -> Plan:
        """Re-resolve ``key`` and swap the result in atomically. The old
        entry keeps serving concurrent ``get``s for the whole duration of
        the solve — this is the off-critical-path half of drift refresh
        (call it from a worker thread; dict replacement is GIL-atomic).

        Planner-backed policies memoize solves internally, so the policy
        is asked to ``invalidate()`` first when it knows how — otherwise a
        "re-solve" would be a memo hit returning the identical plan."""
        phase, *rest = key
        skew = rest.pop() if rest and isinstance(rest[-1], SkewSummary) \
            else None
        if len(rest) == 1 and isinstance(rest[0], OccupancySummary):
            seq_bucket, batch, occupancy = None, None, rest[0]
        else:
            seq_bucket, batch, occupancy = rest[0], rest[1], None
        inval = getattr(self.policy, "invalidate", None)
        if callable(inval):
            inval()
        t0 = time.perf_counter()
        plan = self._resolve(phase, seq_bucket, batch, occupancy, skew)
        dt = time.perf_counter() - t0
        self.stats.refreshes += 1
        self.stats.solve_time_last = dt
        self.stats.solve_time_total += dt
        meta = self._meta.get(key)
        if meta is not None:
            meta.solve_s = dt
        else:
            self._tick += 1
            self._meta[key] = EntryMeta(solve_s=dt, last_used=self._tick)
        self._plans[key] = plan
        self._evict_over_capacity(keep=key)
        return plan

    def _resolve(self, phase, seq_bucket, batch_per_device, occupancy,
                 skew=None):
        # legacy policies without a skew= keyword solve under the uniform
        # assumption — the entry still keys on the summary, so a skew
        # regime shift re-consults the policy rather than serving stale
        kw = {"skew": skew} if (skew is not None and self._skew_aware) else {}
        if occupancy is None:
            return self.policy.resolve(phase, seq_bucket, batch_per_device,
                                       **kw)
        if self._occupancy_aware:
            return self.policy.resolve(phase, seq_bucket, batch_per_device,
                                       occupancy=occupancy, **kw)
        warnings.warn(
            f"policy {getattr(self.policy, 'name', self.policy)!r} has a "
            "legacy resolve(phase, seq_bucket, batch) signature; occupancy "
            "summaries are projected onto (seq_bucket, live). Add an "
            "occupancy= keyword to resolve() to schedule on the real "
            "composition.", DeprecationWarning, stacklevel=3)
        return self.policy.resolve(
            phase, seq_bucket if seq_bucket is not None
            else occupancy.seq_bucket,
            batch_per_device if batch_per_device is not None
            else occupancy.live)

    def entries(self) -> Dict[PlanKey, Plan]:
        return dict(self._plans)

    def distinct_plans(self):
        """Unique resolved plans (Plan is a frozen dataclass => hashable)."""
        return set(self._plans.values())

    def clear(self) -> None:
        self._plans.clear()
        self._meta.clear()
        self._tick = 0
        self.stats = PlanCacheStats()

    def __len__(self) -> int:
        return len(self._plans)

    def __repr__(self) -> str:
        s = self.stats
        return (f"PlanCache(policy={getattr(self.policy, 'name', '?')}, "
                f"entries={len(self)}, hits={s.hits}, misses={s.misses}, "
                f"solve_total={s.solve_time_total * 1e3:.1f}ms)")
