"""A copy of ``repro.placement.placement``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Expert placement: which EP rank owns each expert, and which hot
experts are replicated onto every rank.

FinDEP solves schedules over a *uniform* expert layout — E/eg experts
per rank, uniform token routing. Real gates route with heavy skew
(Zipf-like popularity), so the EG lane's makespan is governed by the
most-loaded rank, not the mean. This module owns the *place* step of the
observe -> place -> plan loop:

    ExpertLoadTracker (tracker.py)  per-layer [E] EWMA token loads
            |  aggregated loads
            v
    rebalance(loads, ...) -> Placement      (greedy, this module)
            |  assignment + replica set + epoch
            v
    taskgraph.lower(hot_experts=, placement_epoch=)   replica-aware IR
    dep.moe_apply_dep(placement=)                     replicated walk
    FinDEPPlanner.plan(skew=)                         skew-aware solve

A ``Placement`` is frozen and hashable: the ``epoch`` scalar is what
flows into ``TaskGraph`` identity and ``PlanCache`` keys, so a placement
change can never serve a stale replica layout.

Replication model: the top-k hottest experts are replicated onto EVERY
EP rank (MegaScale-style hot replication). Their tokens never cross the
A2E/E2A wire — each attention rank runs the hot FFN on its locally
resident tokens (the REP task on the AG lane) — and the cold experts are
re-assigned to ranks by greedy LPT so the per-rank cold load is as flat
as the equal-slots-per-rank constraint allows (the stacked ``[E, ...]``
weight layout keeps E/eg expert slots per rank).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Placement:
    """Expert -> rank map plus the replica set, one epoch of the
    re-balancer.

    ``assignment[e]`` is the EP rank owning logical expert ``e`` (its
    single home for the A2E dispatch); ``replicated`` lists the logical
    ids of the hot experts additionally materialized on every rank.
    ``perm`` is the logical -> physical slot permutation realizing the
    assignment on the stacked ``[E, ...]`` weight arrays (physical slot
    ``perm[e]`` holds logical expert ``e``'s weights); the identity perm
    means the weights need no movement. ``loads`` records the (mean-one
    normalized) load histogram the placement was solved against — carried
    for telemetry/benchmarks, excluded from identity."""

    num_experts: int
    num_ranks: int
    assignment: Tuple[int, ...]
    replicated: Tuple[int, ...] = ()
    epoch: int = 0
    loads: Tuple[float, ...] = field(default=(), compare=False)

    def __post_init__(self):
        if len(self.assignment) != self.num_experts:
            raise ValueError("assignment must cover every expert")
        if self.num_experts % self.num_ranks:
            raise ValueError("experts must divide evenly across ranks "
                             "(stacked weight layout)")
        per = self.experts_per_rank
        counts = [0] * self.num_ranks
        for r in self.assignment:
            if not 0 <= r < self.num_ranks:
                raise ValueError(f"rank {r} out of range")
            counts[r] += 1
        if any(c != per for c in counts):
            raise ValueError(f"assignment must give every rank exactly "
                             f"{per} experts, got {counts}")
        if len(set(self.replicated)) != len(self.replicated):
            raise ValueError("duplicate replicated expert")
        for e in self.replicated:
            if not 0 <= e < self.num_experts:
                raise ValueError(f"replicated expert {e} out of range")

    @property
    def experts_per_rank(self) -> int:
        return self.num_experts // self.num_ranks

    @property
    def hot_experts(self) -> int:
        return len(self.replicated)

    @property
    def is_uniform(self) -> bool:
        """True when this placement executes exactly the unreplicated
        contiguous layout (rank r owns experts [r*per, (r+1)*per)) —
        the bit-identical fast path in ``dep.moe_apply_dep``."""
        return not self.replicated and self.assignment == tuple(
            e // self.experts_per_rank for e in range(self.num_experts))

    @property
    def perm(self) -> Tuple[int, ...]:
        """Logical expert -> physical slot permutation: rank ``r``'s
        slots ``[r*per, (r+1)*per)`` hold the experts assigned to it, in
        ascending logical order (so the uniform assignment yields the
        identity)."""
        per = self.experts_per_rank
        next_slot = [r * per for r in range(self.num_ranks)]
        out = [0] * self.num_experts
        for e, r in enumerate(self.assignment):
            out[e] = next_slot[r]
            next_slot[r] += 1
        return tuple(out)

    def rank_of(self, expert: int) -> int:
        return self.assignment[expert]

    @staticmethod
    def uniform(num_experts: int, num_ranks: int,
                epoch: int = 0) -> "Placement":
        """The pre-placement layout: contiguous blocks, no replicas."""
        per = num_experts // num_ranks
        return Placement(num_experts=num_experts, num_ranks=num_ranks,
                         assignment=tuple(e // per
                                          for e in range(num_experts)),
                         replicated=(), epoch=epoch)


def _normalize(loads: Sequence[float]) -> np.ndarray:
    arr = np.asarray(loads, dtype=np.float64)
    if arr.ndim != 1:
        raise ValueError("loads must be a [E] histogram")
    total = float(arr.sum())
    if total <= 0.0:
        return np.ones(arr.shape[0]) / arr.shape[0]
    return arr / total


def rank_loads(placement: Placement,
               loads: Sequence[float]) -> np.ndarray:
    """Per-rank cold token-load fractions under ``placement`` —
    replicated experts contribute nothing to the EG lane (their tokens
    stay on the attention ranks)."""
    frac = _normalize(loads)
    hot = set(placement.replicated)
    out = np.zeros(placement.num_ranks)
    for e, r in enumerate(placement.assignment):
        if e not in hot:
            out[r] += frac[e]
    return out


def max_rank_load(placement: Placement, loads: Sequence[float]) -> float:
    """Max per-rank cold load fraction: the EG lane's EXP task time
    scales with this (worst rank bounds the lane, Section 3's mutual
    exclusion)."""
    return float(rank_loads(placement, loads).max())


def modeled_exp_time(placement: Placement, loads: Sequence[float],
                     t_exp_uniform: float) -> float:
    """Modeled worst-rank EXP stage time: the uniform-layout stage time
    scaled by how much the hottest rank exceeds the uniform 1/eg share.
    The quantity ``rebalance`` greedily minimizes."""
    uniform_share = 1.0 / placement.num_ranks
    return t_exp_uniform * max_rank_load(placement, loads) / uniform_share


def rebalance(loads: Sequence[float], num_ranks: int,
              replicate_hot_k: int = 0, epoch: int = 0) -> Placement:
    """Greedy re-placement for an observed [E] load histogram.

    1. The ``replicate_hot_k`` hottest experts are replicated onto every
       rank; their tokens leave the EG lane entirely (REP task on AG).
    2. The cold experts are assigned by LPT (longest processing time
       first) under the equal-slots-per-rank constraint: heaviest expert
       to the currently lightest rank that still has a free slot. The
       replicated experts' slots keep their weights resident where the
       LPT pass parks them (every rank also holds a replica copy), so
       slot counts stay uniform.

    Deterministic: ties break toward the lower expert id / lower rank.
    """
    frac = _normalize(loads)
    E = frac.shape[0]
    if E % num_ranks:
        raise ValueError("experts must divide evenly across ranks")
    k = max(int(replicate_hot_k), 0)
    k = min(k, E - num_ranks)  # keep >= 1 cold expert per rank slot-able
    # hottest k experts, ties to lower id (stable argsort on -load)
    order = np.argsort(-frac, kind="stable")
    hot = tuple(sorted(int(e) for e in order[:k]))
    hot_set = set(hot)

    per = E // num_ranks
    slots = [per] * num_ranks
    bins = [0.0] * num_ranks
    assignment = [0] * E
    # LPT over every expert (hot experts weigh 0 on the EG lane but
    # still occupy a slot — the stacked layout is uniform)
    weights = [(0.0 if e in hot_set else float(frac[e]), e)
               for e in range(E)]
    for w, e in sorted(weights, key=lambda we: (-we[0], we[1])):
        r = min((r for r in range(num_ranks) if slots[r] > 0),
                key=lambda r: (bins[r], r))
        assignment[e] = r
        slots[r] -= 1
        bins[r] += w
    return Placement(num_experts=E, num_ranks=num_ranks,
                     assignment=tuple(assignment), replicated=hot,
                     epoch=epoch,
                     loads=tuple(float(x) for x in frac * E))
