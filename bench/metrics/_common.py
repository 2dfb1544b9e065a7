"""Arithmetic the readers share."""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics); None for
    no values."""
    v = np.asarray(list(values), dtype=np.float64)
    return float(np.percentile(v, q)) if v.size else None


def gaps_in(times: List[float], t0: float, t1: float) -> List[float]:
    """The gaps between consecutive times that both lie in [t0, t1]."""
    inside = [t for t in times if t0 <= t <= t1]
    return [b - a for a, b in zip(inside, inside[1:])]
