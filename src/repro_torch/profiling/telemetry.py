"""A copy of ``repro.profiling.telemetry``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Runtime telemetry: measured step wall-times vs the cost model.

The solver picks plans by *modeled* makespan; the ``StepTimer`` is the
observability half of the loop — the serving engine drives it once per
prefill chunk / decode step with the measured wall-time and the plan's
predicted makespan, and it exposes predicted-vs-measured residuals

    residual = (measured - predicted) / predicted

aggregated two ways:

  * per phase  ("prefill" / "decode")      — coarse health dashboard;
  * per plan-cache key (EWMA)              — the signal drift detection
    (``repro_torch.profiling.refresh``) consumes to decide that ONE cached
    plan's cost model has gone stale.

Observations may carry a per-primitive ``breakdown`` — the lowered task
graph's modeled gemm/attn/comm seconds (``Plan.breakdown``, from
``taskgraph.ScheduleResult.breakdown``). Per-key breakdown and measured
sums accumulate alongside the EWMA so drift attribution
(``repro_torch.profiling.attribution``) can solve for per-primitive scale
factors instead of rescaling the whole profile uniformly.

Feeding the timer the model's own predictions yields residual 0 by
construction — that identity is the subsystem's unit-test anchor.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Hashable, Mapping, Optional


@dataclass
class PhaseStats:
    """Aggregate of every observation for one phase."""

    count: int = 0
    measured_s: float = 0.0
    predicted_s: float = 0.0     # only observations that carried a prediction
    predicted_count: int = 0
    last_measured_s: float = 0.0
    last_residual: Optional[float] = None

    @property
    def residual(self) -> Optional[float]:
        """Relative residual over all predicted observations:
        (sum measured - sum predicted) / sum predicted."""
        if self.predicted_count == 0 or self.predicted_s <= 0.0:
            return None
        return (self.measured_s - self.predicted_s) / self.predicted_s

    def as_dict(self) -> dict:
        return dict(count=self.count, measured_s=self.measured_s,
                    predicted_s=self.predicted_s, residual=self.residual,
                    last_residual=self.last_residual)


@dataclass
class KeyStats:
    """Per plan-cache-key residual tracking (EWMA-smoothed).

    The first ``warmup_left`` observations are discarded: a key's first
    execution typically includes jit compilation, and seconds of XLA
    compile measured against a millisecond makespan would poison the EWMA
    (and, downstream, trigger a bogus drift rescale).

    ``measured_s`` / ``predicted_s`` / ``breakdown`` are post-warmup sums;
    ``breakdown`` holds the summed per-primitive (gemm/attn/comm)
    predicted seconds from the plan's lowered task graph, the rows
    per-primitive drift attribution fits its scale factors on."""

    count: int = 0
    residual_ewma: Optional[float] = None
    last_residual: Optional[float] = None
    warmup_left: int = 0
    measured_s: float = 0.0
    predicted_s: float = 0.0
    breakdown: Dict[str, float] = field(default_factory=dict)

    def update(self, residual: float, smoothing: float,
               measured_s: float = 0.0, predicted_s: float = 0.0,
               breakdown: Optional[Mapping[str, float]] = None) -> None:
        self.last_residual = residual
        if self.warmup_left > 0:
            self.warmup_left -= 1
            return
        self.count += 1
        self.measured_s += measured_s
        self.predicted_s += predicted_s
        if breakdown:
            for k, v in breakdown.items():
                self.breakdown[k] = self.breakdown.get(k, 0.0) + float(v)
        if self.residual_ewma is None:
            self.residual_ewma = residual
        else:
            a = smoothing
            self.residual_ewma = a * residual + (1 - a) * self.residual_ewma

    def reset(self, warmup: int = 0) -> None:
        self.count = 0
        self.residual_ewma = None
        self.last_residual = None
        self.warmup_left = warmup
        self.measured_s = 0.0
        self.predicted_s = 0.0
        self.breakdown = {}


class StepTimer:
    """Per-phase / per-plan-key predicted-vs-measured accounting.

    ``smoothing`` is the EWMA weight of the newest per-key residual
    (1.0 = no smoothing); ``key_warmup`` observations per key are
    excluded from the EWMA (first-call jit compilation)."""

    def __init__(self, smoothing: float = 0.5, key_warmup: int = 1):
        assert 0.0 < smoothing <= 1.0
        self.smoothing = smoothing
        self.key_warmup = key_warmup
        self.phases: Dict[str, PhaseStats] = {}
        self.keys: Dict[Hashable, KeyStats] = {}

    def observe(self, phase: str, measured_s: float,
                predicted_s: Optional[float] = None,
                key: Optional[Hashable] = None,
                breakdown: Optional[Mapping[str, float]] = None
                ) -> Optional[float]:
        """Record one measured interval; returns the observation's relative
        residual (None when there was no usable prediction).
        ``breakdown`` optionally tags the prediction with its modeled
        per-primitive (gemm/attn/comm) split from the plan's lowered
        task graph."""
        ph = self.phases.setdefault(phase, PhaseStats())
        ph.count += 1
        ph.measured_s += measured_s
        ph.last_measured_s = measured_s
        residual = None
        if predicted_s is not None and predicted_s > 0.0:
            ph.predicted_s += predicted_s
            ph.predicted_count += 1
            residual = (measured_s - predicted_s) / predicted_s
            ph.last_residual = residual
            if key is not None:
                self.keys.setdefault(
                    key, KeyStats(warmup_left=self.key_warmup)).update(
                    residual, self.smoothing, measured_s=measured_s,
                    predicted_s=predicted_s, breakdown=breakdown)
        return residual

    @contextmanager
    def measure(self, phase: str, predicted_s: Optional[float] = None,
                key: Optional[Hashable] = None,
                breakdown: Optional[Mapping[str, float]] = None):
        """Context manager timing a block and recording it. The caller is
        responsible for blocking on device results inside the block."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(phase, time.perf_counter() - t0,
                         predicted_s=predicted_s, key=key,
                         breakdown=breakdown)

    # -- readers --------------------------------------------------------
    def residuals(self) -> Dict[str, Optional[float]]:
        """Per-phase relative residuals (None where nothing was
        predicted)."""
        return {ph: st.residual for ph, st in self.phases.items()}

    def key_residual(self, key: Hashable) -> Optional[float]:
        st = self.keys.get(key)
        return st.residual_ewma if st is not None else None

    def reset_key(self, key: Hashable) -> None:
        """Forget a key's residual history (after its plan was refreshed —
        old residuals described the replaced plan's model; the warmup also
        re-arms, since a refreshed schedule may retrace)."""
        st = self.keys.get(key)
        if st is not None:
            st.reset(warmup=self.key_warmup)

    def reset(self) -> None:
        """Forget ALL history: phase aggregates and every per-key EWMA.
        This is what the metrics registry's reset hook calls — before it
        existed, ``EngineStats.reset()`` left the EWMAs (and their
        consumed warmups) leaking across a warmup/measure boundary."""
        self.phases = {}
        self.keys = {}

    def summary(self) -> Dict[str, dict]:
        return {ph: st.as_dict() for ph, st in self.phases.items()}

    def snapshot(self) -> Dict[str, float]:
        """Flat numeric dict for the metrics registry: per-phase counts,
        measured/predicted sums and residuals, plus cross-key residual
        EWMA extrema (key objects themselves are not label-safe)."""
        out: Dict[str, float] = {}
        for ph, st in self.phases.items():
            out[f"{ph}_count"] = st.count
            out[f"{ph}_measured_s"] = st.measured_s
            out[f"{ph}_predicted_s"] = st.predicted_s
            if st.residual is not None:
                out[f"{ph}_residual"] = st.residual
        ewmas = [st.residual_ewma for st in self.keys.values()
                 if st.residual_ewma is not None]
        out["tracked_keys"] = len(self.keys)
        if ewmas:
            out["key_residual_ewma_max"] = max(ewmas)
            out["key_residual_ewma_min"] = min(ewmas)
        return out

    def __repr__(self) -> str:
        parts = []
        for ph, st in sorted(self.phases.items()):
            r = st.residual
            parts.append(f"{ph}: n={st.count} measured={st.measured_s:.3f}s"
                         + (f" residual={r:+.1%}" if r is not None else ""))
        return f"StepTimer({'; '.join(parts) or 'empty'})"
