"""A copy of ``repro.profiling.attribution``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Per-primitive drift attribution: solve for gemm/attn/comm scale
factors from task-tagged residuals.

The solver predicts each plan's makespan as a composition of three
alpha-beta primitives; the lowered task graph tags every prediction with
its per-primitive split (``Plan.breakdown``). When measured wall-times
drift, keys with DIFFERENT compositions (a GEMM-bound prefill bucket vs
a comm-bound decode occupancy) over- or under-shoot differently — that
contrast is enough to solve, in least squares,

    measured_k  ~=  s_gemm * b_gemm_k + s_attn * b_attn_k + s_comm * b_comm_k

for the per-primitive scale factors ``s`` across the observed keys k.
``DriftMonitor`` applies them via ``HardwareProfile.scaled_by`` so a comm
slowdown retunes alpha_c/beta_c without inflating the compute terms
(which would mis-rank plans whose bottleneck is compute).

When the observations cannot identify the scales — fewer independent
compositions than active primitives, a singular fit, or non-physical
(non-positive) solutions — ``fit_primitive_scales`` returns None and the
caller falls back to the uniform whole-profile rescale.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np

PRIMITIVES = ("gemm", "attn", "comm")

#: an attribution row: (per-primitive predicted seconds, measured seconds)
Row = Tuple[Mapping[str, float], float]


def fit_primitive_scales(rows: Iterable[Row], *, clamp: float = 10.0,
                         min_rows: int = 2,
                         primitives: Sequence[str] = PRIMITIVES
                         ) -> Optional[Dict[str, float]]:
    """Least-squares fit of measured = sum_p s_p * predicted_p over
    observation rows. Returns {primitive: scale} with every scale
    clamped to [1/clamp, clamp], or None when the system is not
    identifiable (too few rows, rank-deficient compositions, or a
    non-physical fit) — the caller should then fall back to a uniform
    rescale.

    Primitives whose predicted column is (near) zero everywhere carry no
    signal; they are excluded from the solve and returned with scale 1.0.
    """
    data = [(dict(b), float(m)) for b, m in rows if b]
    if len(data) < min_rows:
        return None
    M = np.asarray([[row.get(p, 0.0) for p in primitives]
                    for row, _ in data], dtype=np.float64)
    m = np.asarray([meas for _, meas in data], dtype=np.float64)
    if not (np.all(np.isfinite(M)) and np.all(np.isfinite(m))):
        return None
    # drop zero-signal columns (scale unidentifiable -> keep at 1.0)
    col_mag = np.abs(M).sum(axis=0)
    active = col_mag > 1e-12 * max(col_mag.max(), 1e-300)
    if not active.any():
        return None
    Ma = M[:, active]
    sol, _, rank, _ = np.linalg.lstsq(Ma, m, rcond=None)
    if rank < Ma.shape[1] or not np.all(np.isfinite(sol)):
        return None
    if np.any(sol <= 0.0):
        # a negative/zero time scale is non-physical: the compositions
        # were too collinear to separate the primitives
        return None
    scales = {p: 1.0 for p in primitives}
    for p, s in zip(np.asarray(primitives)[active], sol):
        scales[str(p)] = float(min(max(s, 1.0 / clamp), clamp))
    return scales


def attribution_rows(key_stats: Mapping) -> list:
    """Extract attribution rows from a ``StepTimer.keys`` mapping: one
    (per-step mean breakdown, per-step mean measured) row per key that
    accumulated task-tagged observations past warmup.

    Rows are normalized by each key's observation count so a hot key
    (thousands of decode steps) does not outweigh a rarely-observed
    composition by count² in the least-squares objective — the fit
    should be driven by the CONTRAST between compositions, not by how
    often each one ran."""
    rows = []
    for st in key_stats.values():
        if getattr(st, "breakdown", None) and st.count > 0:
            n = st.count
            rows.append(({k: v / n for k, v in st.breakdown.items()},
                         st.measured_s / n))
    return rows
