"""A copy of ``repro.obs.overlap``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.


The solver optimizes a *modeled* makespan; ROADMAP item 3's win claim is
"executed overlap == scheduled overlap within eps". This module computes
both sides of that equation from one pair of inputs:

  * executed: ``cat="task"`` spans from a ``TraceRecorder`` (produced by
    ``obs.replay`` on host lanes, or by any future on-device profiler
    that tags spans with the IR's kind/lane coordinates);
  * scheduled: the lowered graph's ``taskgraph.ScheduleResult``.

Reductions (same interval algebra as ``core.simulator``'s Table 7
metric, reimplemented here over spans):

  * per-lane busy / idle occupancy within the executed window;
  * exposed communication — link (A2E/E2A) busy while neither compute
    lane (AG/EG) runs — total and per comm lane;
  * per-primitive-class busy (gemm/attn/comm via ``KIND_CLASS``), the
    executed counterpart of the plan's ``CostBreakdown``.

``attribute_overlap`` diffs the two sides into an ``OverlapReport``.
Because a host replay runs time-scaled, the headline gap metric is the
difference of exposed-comm *fractions of makespan* (scale cancels);
absolute executed seconds are de-scaled for side-by-side reporting.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.taskgraph import (KIND_CLASS, RESOURCES,
                                        CostBreakdown, ScheduleResult)
from repro_torch.obs.trace import Span

Interval = Tuple[float, float]

COMM_LANES = ("A2E", "E2A")
COMPUTE_LANES = ("AG", "EG")


# ---------------------------------------------------------------------------
# interval algebra
# ---------------------------------------------------------------------------


def interval_union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merge overlapping/adjacent intervals into a disjoint sorted list."""
    out: List[Interval] = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def interval_subtract(a: Sequence[Interval],
                      b: Sequence[Interval]) -> List[Interval]:
    """``a - b`` for disjoint sorted interval lists (see
    ``interval_union``)."""
    out: List[Interval] = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if be >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def interval_total(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals)


# ---------------------------------------------------------------------------
# span reductions
# ---------------------------------------------------------------------------


def lane_intervals(spans: Iterable[Span]) -> Dict[str, List[Interval]]:
    """Executed task spans grouped into per-lane merged busy intervals
    (lane = the span's ``lane`` arg, falling back to its track)."""
    raw: Dict[str, List[Interval]] = {}
    for s in spans:
        lane = s.arg("lane", s.track)
        raw.setdefault(lane, []).append((s.start, s.end))
    return {lane: interval_union(iv) for lane, iv in raw.items()}


@dataclass(frozen=True)
class LaneOccupancy:
    """Busy/idle seconds of one lane within the executed window."""

    lane: str
    busy: float
    idle: float
    first: float
    last: float

    @property
    def utilization(self) -> float:
        span = self.busy + self.idle
        return self.busy / span if span > 0 else 0.0


def lane_occupancy(spans: Iterable[Span],
                   window: Optional[Interval] = None
                   ) -> Dict[str, LaneOccupancy]:
    """Per-lane busy/idle within ``window`` (default: first span start to
    last span end over ALL lanes, so idle includes waiting for other
    lanes)."""
    lanes = lane_intervals(spans)
    if not lanes:
        return {}
    if window is None:
        lo = min(iv[0][0] for iv in lanes.values() if iv)
        hi = max(iv[-1][1] for iv in lanes.values() if iv)
        window = (lo, hi)
    out = {}
    for lane, iv in lanes.items():
        busy = interval_total(iv)
        out[lane] = LaneOccupancy(
            lane=lane, busy=busy,
            idle=max(window[1] - window[0] - busy, 0.0),
            first=iv[0][0] if iv else window[0],
            last=iv[-1][1] if iv else window[0])
    return out


def executed_exposed_comm(spans: Iterable[Span]) -> Dict[str, float]:
    """Exposed-communication seconds from executed task spans: per comm
    lane and total, each = lane busy time not covered by any compute
    lane's busy time."""
    lanes = lane_intervals(spans)
    compute = interval_union(
        [iv for lane in COMPUTE_LANES for iv in lanes.get(lane, [])])
    out: Dict[str, float] = {}
    total = 0.0
    for lane in COMM_LANES:
        exp = interval_total(
            interval_subtract(lanes.get(lane, []), compute))
        out[lane] = exp
        total += exp
    out["total"] = total
    return out


def scheduled_exposed_comm(result: ScheduleResult) -> Dict[str, float]:
    """The modeled counterpart, from the schedule's per-lane intervals
    (same algebra as ``simulator.non_overlapped_comm_time``, here kept
    per comm lane)."""
    iv = result.intervals
    compute = interval_union(
        [x for lane in COMPUTE_LANES for x in iv.get(lane, [])])
    out: Dict[str, float] = {}
    total = 0.0
    for lane in COMM_LANES:
        exp = interval_total(
            interval_subtract(interval_union(iv.get(lane, [])), compute))
        out[lane] = exp
        total += exp
    out["total"] = total
    return out


def class_busy(spans: Iterable[Span]) -> Dict[str, float]:
    """Executed busy seconds per hardware-primitive class — the executed
    counterpart of ``CostBreakdown`` (sums span durations by the kind
    tag's ``KIND_CLASS``)."""
    out = {"gemm": 0.0, "attn": 0.0, "comm": 0.0}
    for s in spans:
        cls = KIND_CLASS.get(s.arg("kind", s.name))
        if cls is not None:
            out[cls] += s.duration
    return out


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


@dataclass
class OverlapReport:
    """Executed vs scheduled, side by side. All executed seconds are
    de-scaled by the replay's ``time_scale`` so they are directly
    comparable to the modeled values; ``gap`` is the difference of
    exposed-comm fractions of makespan (dimensionless, scale-free):

        gap = | exposed_exec / makespan_exec
              - exposed_model / makespan_model |
    """

    makespan_modeled: float
    makespan_executed: float
    exposed_modeled: Dict[str, float]
    exposed_executed: Dict[str, float]
    busy_modeled: Dict[str, float]
    busy_executed: Dict[str, float]
    idle_executed: Dict[str, float]
    breakdown_modeled: CostBreakdown
    breakdown_executed: Dict[str, float] = field(default_factory=dict)
    time_scale: float = 1.0

    @property
    def exposed_frac_modeled(self) -> float:
        if self.makespan_modeled <= 0:
            return 0.0
        return self.exposed_modeled["total"] / self.makespan_modeled

    @property
    def exposed_frac_executed(self) -> float:
        if self.makespan_executed <= 0:
            return 0.0
        return self.exposed_executed["total"] / self.makespan_executed

    @property
    def gap(self) -> float:
        return abs(self.exposed_frac_executed - self.exposed_frac_modeled)

    def within(self, eps: float) -> bool:
        """The win-claim predicate: executed overlap matches scheduled
        overlap to ``eps`` (fraction of makespan)."""
        return self.gap <= eps

    def as_dict(self) -> Dict[str, float]:
        out = {
            "makespan_modeled_s": self.makespan_modeled,
            "makespan_executed_s": self.makespan_executed,
            "exposed_frac_modeled": self.exposed_frac_modeled,
            "exposed_frac_executed": self.exposed_frac_executed,
            "gap": self.gap,
            "time_scale": self.time_scale,
        }
        for lane in COMM_LANES + ("total",):
            out[f"exposed_modeled_{lane}_s"] = self.exposed_modeled[lane]
            out[f"exposed_executed_{lane}_s"] = self.exposed_executed[lane]
        for lane in RESOURCES:
            if lane in self.busy_executed:
                out[f"busy_executed_{lane}_s"] = self.busy_executed[lane]
                out[f"idle_executed_{lane}_s"] = self.idle_executed[lane]
            out[f"busy_modeled_{lane}_s"] = self.busy_modeled.get(lane, 0.0)
        for cls, v in self.breakdown_executed.items():
            out[f"busy_executed_{cls}_s"] = v
        for cls, v in self.breakdown_modeled.as_dict().items():
            out[f"busy_modeled_{cls}_s"] = v
        return out


def attribute_overlap(spans: Iterable[Span], result: ScheduleResult,
                      time_scale: float = 1.0) -> OverlapReport:
    """Reduce executed task ``spans`` and diff against the scheduled
    ``result``. ``time_scale`` is the replay's duration multiplier
    (executed seconds are divided by it for reporting; the gap metric is
    scale-free either way)."""
    spans = list(spans)
    occ = lane_occupancy(spans)
    exec_exposed = executed_exposed_comm(spans)
    makespan_exec = 0.0
    if occ:
        lo = min(o.first for o in occ.values())
        hi = max(o.last for o in occ.values())
        makespan_exec = hi - lo
    k = 1.0 / time_scale if time_scale > 0 else 1.0
    return OverlapReport(
        makespan_modeled=result.makespan,
        makespan_executed=makespan_exec * k,
        exposed_modeled=scheduled_exposed_comm(result),
        exposed_executed={lane: v * k for lane, v in exec_exposed.items()},
        busy_modeled=dict(result.busy),
        busy_executed={lane: o.busy * k for lane, o in occ.items()},
        idle_executed={lane: o.idle * k for lane, o in occ.items()},
        breakdown_modeled=result.breakdown(),
        breakdown_executed={cls: v * k
                            for cls, v in class_busy(spans).items()},
        time_scale=time_scale)
