"""A copy of ``repro.placement.tracker``, kept by the port so that it
imports nothing of the JAX package, with one change: ``ExpertLoadTracker``
keeps its per-layer EWMA as one [layers, E] array, so that a step's update
is not a loop over layers. The tests hold the two against each other.

Expert load telemetry: per-layer EWMA token-load histograms and the
quantized skew summary the planner and ``PlanCache`` key on.

The gate already computes per-expert assignment counts (the routing
onehot in ``models/moe.py``); ``moe_dispatch`` now surfaces them as
``DispatchInfo.load`` and the engine feeds each step's stacked ``[L, E]``
histogram here. The tracker mirrors ``StepTimer``'s shape: EWMA with a
smoothing factor, per-key (here per-layer) state, cheap ``reset``.

``SkewSummary`` is the frozen, ordered, quantized projection of the
tracker + active placement that (a) keys ``PlanCache`` entries and the
planner's solve memo — recurring skew regimes cost a dict lookup, and
(b) carries the three scale factors the skew-aware cost model needs:

    kappa      worst-rank cold load / uniform 1/eg share — multiplies
               the modeled EXP task time (the lane is bound by its
               most-loaded rank, not the mean)
    rho        fraction of routed tokens handled by replicated hot
               experts — they never cross the A2E/E2A wire, so comm
               volume scales by (1 - rho) and the REP task runs rho of
               the uniform-layout expert FLOPs per attention rank
    max_expert single hottest expert's load / uniform 1/E share —
               scales ``expert_capacity`` so the executed dispatch
               keeps the hot expert's tokens instead of dropping them
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.placement.placement import (Placement, _normalize,
                                       max_rank_load)

#: quantization step for SkewSummary fields — coarse enough that a
#: stable skew regime maps to ONE summary (plan-cache hit), fine enough
#: that a real shift re-solves.
_QUANT = 0.125


def _q(x: float) -> float:
    return round(float(x) / _QUANT) * _QUANT


@dataclass(frozen=True, order=True)
class SkewSummary:
    """Quantized routing-skew fingerprint (hashable plan-cache key
    component). ``hot_k`` and ``epoch`` come from the active placement;
    the float fields are quantized to ``_QUANT`` steps."""

    kappa: float = 1.0
    rho: float = 0.0
    max_expert: float = 1.0
    hot_k: int = 0
    epoch: int = 0

    @property
    def is_uniform(self) -> bool:
        return (self.kappa == 1.0 and self.rho == 0.0
                and self.max_expert == 1.0 and self.hot_k == 0)


#: the no-telemetry default: uniform routing, no replication, epoch 0.
UNIFORM_SKEW = SkewSummary()


class ExpertLoadTracker:
    """Per-layer ``[E]`` EWMA of gate token loads.

    ``observe`` takes one step's histogram — ``[E]`` (a single layer or
    an already-aggregated model step) or ``[L, E]`` stacked per layer —
    normalized to fractions internally so prefill (many tokens) and
    decode (one token per slot) steps weigh equally per observation.
    """

    def __init__(self, num_experts: int, smoothing: float = 0.2):
        if not 0.0 < smoothing <= 1.0:
            raise ValueError("smoothing must be in (0, 1]")
        self.num_experts = int(num_experts)
        self.smoothing = float(smoothing)
        # [layers, E] EWMA fractions, one row per layer observed so far;
        # one array (not the reference's dict of rows) so that a step's
        # update is a few whole-array operations, not a loop over layers
        self._ewma = np.zeros((0, self.num_experts))
        self.observations = 0

    def observe(self, loads) -> None:
        arr = np.asarray(loads, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2 or arr.shape[1] != self.num_experts:
            raise ValueError(
                f"expected [L, {self.num_experts}] loads, got {arr.shape}")
        # each row normalized as ``_normalize`` does; a row with no load
        # is uniform
        total = arr.sum(axis=1, keepdims=True)
        frac = np.where(total > 0.0, arr / np.where(total > 0.0, total, 1.0),
                        1.0 / self.num_experts)
        a = self.smoothing
        seen = min(arr.shape[0], self._ewma.shape[0])
        self._ewma[:seen] = a * frac[:seen] + (1.0 - a) * self._ewma[:seen]
        if arr.shape[0] > seen:
            self._ewma = np.concatenate([self._ewma, frac[seen:]])
        self.observations += 1

    @property
    def layers(self) -> int:
        return self._ewma.shape[0]

    def layer_loads(self, layer: int) -> Optional[np.ndarray]:
        if not 0 <= layer < self.layers:
            return None
        return self._ewma[layer].copy()

    def aggregate(self) -> np.ndarray:
        """Mean of the per-layer EWMA fractions — the [E] histogram the
        (layer-shared) placement is solved against. Uniform before any
        observation."""
        if not self.layers:
            return np.ones(self.num_experts) / self.num_experts
        return np.mean(self._ewma, axis=0)

    def imbalance(self) -> float:
        """Hottest expert's load as a multiple of the uniform 1/E share
        (1.0 = perfectly balanced) — the re-balance trigger metric."""
        agg = self.aggregate()
        return float(agg.max() * self.num_experts)

    def reset(self) -> None:
        self._ewma = np.zeros((0, self.num_experts))
        self.observations = 0

    def snapshot(self) -> Dict[str, float]:
        """Flat numeric dict for the metrics registry."""
        return {"observations": float(self.observations),
                "layers": float(self.layers),
                "imbalance": self.imbalance()}

    def summary(self, placement: Optional[Placement] = None,
                num_ranks: Optional[int] = None) -> SkewSummary:
        """Project the tracked loads (+ active placement) onto the
        quantized ``SkewSummary`` the planner keys on."""
        if self.observations == 0:
            epoch = placement.epoch if placement is not None else 0
            hot = placement.hot_experts if placement is not None else 0
            return SkewSummary(hot_k=hot, epoch=epoch)
        agg = self.aggregate()
        if placement is None:
            ranks = int(num_ranks) if num_ranks else 1
            placement = Placement.uniform(self.num_experts, ranks) \
                if self.num_experts % ranks == 0 else None
        if placement is None:
            return SkewSummary(max_expert=_q(self.imbalance()))
        frac = _normalize(agg)
        rho = float(sum(frac[e] for e in placement.replicated))
        kappa = (max_rank_load(placement, agg)
                 * placement.num_ranks)
        return SkewSummary(kappa=max(_q(kappa), 0.0),
                           rho=min(max(_q(rho), 0.0), 1.0),
                           max_expert=max(_q(self.imbalance()), 0.0),
                           hot_k=placement.hot_experts,
                           epoch=placement.epoch)


def capacity_scale(skew: Optional[SkewSummary],
                   capacity_factor: float) -> float:
    """Multiplier on the executed expert capacity so the observed
    hottest expert's tokens fit its buffer row: the configured
    ``capacity_factor`` already covers ``capacity_factor`` x the uniform
    1/E share, so only the excess ``max_expert / capacity_factor``
    widens it. 1.0 (no change) when routing is within the configured
    headroom."""
    if skew is None or capacity_factor <= 0:
        return 1.0
    return max(1.0, float(skew.max_expert) / float(capacity_factor))


def zipf_loads(num_experts: int, s: float = 1.2,
               permutation: Optional[Sequence[int]] = None) -> np.ndarray:
    """Zipf(s) load histogram over ``num_experts`` (rank r gets
    1/(r+1)^s, normalized) — the skew regime the benchmark and tests
    replay. ``permutation`` shuffles which expert id is hot."""
    ranks = np.arange(1, num_experts + 1, dtype=np.float64)
    frac = ranks ** (-float(s))
    frac /= frac.sum()
    if permutation is not None:
        out = np.zeros(num_experts)
        out[np.asarray(permutation, dtype=np.int64)] = frac
        return out
    return frac
