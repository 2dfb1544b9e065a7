"""A copy of ``repro.obs.metrics``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.


Before this module the repo had six disjoint stat surfaces
(``EngineStats``, ``StepTimer``, ``PlanCacheStats``, ``paging_summary``,
``ExpertLoadTracker``, drift/refresh counters) each with its own ad-hoc
dict shape. The ``MetricsRegistry`` unifies them behind three primitive
types and two export formats:

  * ``Counter``    monotone float; ``inc()``.
  * ``Gauge``      last-set float, or a pull callback (``fn=``) for
                   values that live elsewhere.
  * ``Histogram``  fixed log-spaced bucket boundaries (``log_buckets``)
                   with count/sum and p50/p99 summaries interpolated
                   within the owning bucket — bounded memory, no sample
                   retention, quantile error bounded by the bucket ratio.

Existing stat objects don't migrate onto the primitives; they register a
*source* — a zero-arg callable returning a flat ``{name: number}`` dict —
and the registry folds each source into every ``snapshot()`` under its
prefix. One ``snapshot()`` therefore sees the engine counters, plan-cache
accounting, telemetry residuals, paging occupancy, and expert-load skew
in a single namespace (metric-name table in DESIGN.md).

Exports:

  * ``snapshot()``            one flat dict (prometheus-style sample
                              names, ``name{label="v"}``);
  * ``export_jsonl(path)``    append one timestamped JSON line;
  * ``render_prometheus()``   text exposition format (HELP/TYPE lines,
                              escaped label values, cumulative histogram
                              buckets) — ``parse_prometheus`` is the
                              matching reference parser the tests and the
                              CI smoke scrape it back through.

``reset()`` is the one warmup boundary: it zeroes every counter and
histogram AND runs the registered reset hooks, so state that lives
outside the registry (``StepTimer`` EWMA residuals, expert-load EWMAs,
paging counters) is cleared in the same call — benchmark warmup can no
longer leak into post-reset drift or re-balance decisions.
"""
from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

Number = float

# ---------------------------------------------------------------------------
# bucket layout
# ---------------------------------------------------------------------------


def log_buckets(lo: float = 1e-5, hi: float = 100.0,
                per_decade: int = 3) -> Tuple[float, ...]:
    """Fixed log-spaced bucket boundaries from ``lo`` to at least ``hi``
    with ``per_decade`` boundaries per decade. The default (1e-5 s ..
    1e2 s) spans microbenchmark primitives to whole-benchmark walls with
    a ~2.15x ratio between adjacent boundaries."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    if per_decade < 1:
        raise ValueError("per_decade must be >= 1")
    n = math.ceil(round(math.log10(hi / lo) * per_decade, 9)) + 1
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n))


DEFAULT_BUCKETS = log_buckets()


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


@dataclass
class Counter:
    """Monotone event counter."""

    name: str
    help: str = ""
    labels: Tuple[Tuple[str, str], ...] = ()
    value: float = 0.0
    kind: str = "counter"

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n

    def reset(self) -> None:
        self.value = 0.0


@dataclass
class Gauge:
    """Last-set value, or a pull callback for externally-owned state."""

    name: str
    help: str = ""
    labels: Tuple[Tuple[str, str], ...] = ()
    fn: Optional[Callable[[], float]] = None
    _value: float = 0.0
    kind: str = "gauge"

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        if self.fn is not None:
            return float(self.fn())
        return self._value

    def reset(self) -> None:
        # callback gauges mirror external state; nothing to clear here
        if self.fn is None:
            self._value = 0.0


@dataclass
class Histogram:
    """Fixed-boundary histogram with interpolated quantile summaries.

    ``bucket_counts[i]`` counts observations v with
    ``buckets[i-1] < v <= buckets[i]`` (``i == 0``: ``v <= buckets[0]``);
    the final slot counts the overflow ``v > buckets[-1]``. ``quantile``
    walks the cumulative counts and interpolates inside the owning bucket
    (geometrically, matching the log-spaced layout), so its error is
    bounded by one bucket ratio — test-locked against numpy quantiles.
    """

    name: str
    help: str = ""
    labels: Tuple[Tuple[str, str], ...] = ()
    buckets: Tuple[float, ...] = DEFAULT_BUCKETS
    bucket_counts: List[int] = field(default_factory=list)
    count: int = 0
    sum: float = 0.0
    kind: str = "histogram"

    def __post_init__(self) -> None:
        if list(self.buckets) != sorted(self.buckets) or not self.buckets:
            raise ValueError("bucket boundaries must be sorted, non-empty")
        if not self.bucket_counts:
            self.bucket_counts = [0] * (len(self.buckets) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.bucket_counts[self._bucket_index(v)] += 1

    def _bucket_index(self, v: float) -> int:
        import bisect
        return bisect.bisect_left(self.buckets, v)

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1] (None when empty)."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.bucket_counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= target:
                if i >= len(self.buckets):       # overflow: clamp
                    return self.buckets[-1]
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                frac = min(max((target - prev) / c, 0.0), 1.0)
                if lo > 0.0:
                    return lo * (hi / lo) ** frac     # geometric interp
                return lo + (hi - lo) * frac
        return self.buckets[-1]

    @property
    def p50(self) -> Optional[float]:
        return self.quantile(0.50)

    @property
    def p99(self) -> Optional[float]:
        return self.quantile(0.99)

    def reset(self) -> None:
        self.bucket_counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0


# ---------------------------------------------------------------------------
# name / label formatting (prometheus exposition conventions)
# ---------------------------------------------------------------------------


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def sample_name(name: str, labels: Mapping[str, str] = ()) -> str:
    """``name{k="v",...}`` with exposition-format label escaping — the
    key format ``snapshot()`` and the JSONL export use."""
    items = sorted(dict(labels).items()) if labels else []
    if not items:
        return name
    body = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items)
    return f"{name}{{{body}}}"


def parse_prometheus(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Reference parser for the text exposition format: returns
    ``(name, labels, value)`` samples, skipping comments/blank lines.
    Handles escaped quotes/backslashes/newlines in label values; raises
    ValueError on malformed lines (CI scrapes ``render_prometheus()``
    through this)."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            out.append(_parse_sample_line(line))
        except Exception as e:
            raise ValueError(f"line {lineno}: {line!r}: {e}") from e
    return out


def _parse_sample_line(line: str) -> Tuple[str, Dict[str, str], float]:
    i = 0
    n = len(line)
    while i < n and (line[i].isalnum() or line[i] in "_:"):
        i += 1
    name = line[:i]
    if not name:
        raise ValueError("missing metric name")
    labels: Dict[str, str] = {}
    if i < n and line[i] == "{":
        i += 1
        while True:
            while i < n and line[i] in ", ":
                i += 1
            if i < n and line[i] == "}":
                i += 1
                break
            j = i
            while j < n and line[j] not in "=":
                j += 1
            key = line[i:j].strip()
            if j >= n or not key:
                raise ValueError("malformed label")
            i = j + 1
            if i >= n or line[i] != '"':
                raise ValueError("label value must be quoted")
            i += 1
            buf = []
            while i < n and line[i] != '"':
                c = line[i]
                if c == "\\":
                    i += 1
                    esc = line[i] if i < n else ""
                    buf.append({"n": "\n", '"': '"', "\\": "\\"}.get(
                        esc, "\\" + esc))
                else:
                    buf.append(c)
                i += 1
            if i >= n:
                raise ValueError("unterminated label value")
            i += 1                                    # closing quote
            labels[key] = "".join(buf)
    value = float(line[i:].split()[0])
    return name, labels, value


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_Metric = (Counter, Gauge, Histogram)


class MetricsRegistry:
    """One namespace over every metric and stat surface.

    ``counter``/``gauge``/``histogram`` create-or-return by
    ``(name, labels)`` identity (same name with different label sets is
    one family, prometheus-style). ``register_source(prefix, fn)``
    attaches a pull-based surface: ``fn()`` returns a flat numeric dict
    folded into every ``snapshot()`` as ``{prefix}_{key}`` gauges.
    ``register_reset(fn)`` attaches external state to the registry-level
    ``reset()``.
    """

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            object] = {}
        self._sources: List[Tuple[str, Callable[[], Mapping[str, float]]]] \
            = []
        self._reset_hooks: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    # -- construction ---------------------------------------------------
    def _get(self, cls, name: str, help: str,
             labels: Optional[Mapping[str, str]], **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name=name, help=help, labels=key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"{name} already registered as {type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(Gauge, name, help, labels)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Mapping[str, str]] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        kw = {"buckets": tuple(buckets)} if buckets is not None else {}
        return self._get(Histogram, name, help, labels, **kw)

    def register_source(self, prefix: str,
                        fn: Callable[[], Mapping[str, float]]) -> None:
        self._sources.append((prefix, fn))

    def register_reset(self, fn: Callable[[], None]) -> None:
        self._reset_hooks.append(fn)

    def metrics(self) -> List[object]:
        return list(self._metrics.values())

    # -- the one reset --------------------------------------------------
    def reset(self) -> None:
        """Zero every counter/histogram/set-gauge AND run the registered
        reset hooks — the single warmup boundary. Stat surfaces whose
        state lives outside the registry (StepTimer EWMAs, expert-load
        EWMAs, paging counters, EngineStats) clear in the same call."""
        for m in self.metrics():
            m.reset()
        for fn in self._reset_hooks:
            fn()

    # -- export ---------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """One flat ``{sample_name: value}`` dict over every metric and
        source. Histograms contribute ``_count``/``_sum``/``_p50``/
        ``_p99`` samples; source values that are None/non-numeric are
        skipped."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            labels = dict(m.labels)
            if isinstance(m, Histogram):
                out[sample_name(m.name + "_count", labels)] = float(m.count)
                out[sample_name(m.name + "_sum", labels)] = m.sum
                for q, tag in ((0.50, "_p50"), (0.99, "_p99")):
                    v = m.quantile(q)
                    if v is not None:
                        out[sample_name(m.name + tag, labels)] = v
            else:
                out[sample_name(m.name, labels)] = float(m.value)
        for prefix, fn in self._sources:
            try:
                vals = fn()
            except Exception:
                continue                     # a dead source never breaks
            for k, v in dict(vals).items():  # the whole snapshot
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if not math.isfinite(float(v)):
                    continue
                out[f"{prefix}_{k}"] = float(v)
        return out

    def export_jsonl(self, path, extra: Optional[Mapping] = None) -> dict:
        """Append one timestamped snapshot line to ``path`` (JSONL)."""
        rec = {"ts": time.time(), "metrics": self.snapshot()}
        if extra:
            rec.update(extra)
        with open(path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        return rec

    def render_prometheus(self) -> str:
        """Prometheus text exposition of every metric and source."""
        lines: List[str] = []
        seen_family: set = set()

        def family(name: str, kind: str, help: str) -> None:
            if name in seen_family:
                return
            seen_family.add(name)
            if help:
                lines.append(f"# HELP {name} {_escape_help(help)}")
            lines.append(f"# TYPE {name} {kind}")

        for m in self.metrics():
            labels = dict(m.labels)
            if isinstance(m, Histogram):
                family(m.name, "histogram", m.help)
                cum = 0
                for b, c in zip(m.buckets, m.bucket_counts):
                    cum += c
                    lab = dict(labels, le=f"{b:g}")
                    lines.append(
                        f"{sample_name(m.name + '_bucket', lab)} {cum}")
                lab = dict(labels, le="+Inf")
                lines.append(
                    f"{sample_name(m.name + '_bucket', lab)} {m.count}")
                lines.append(f"{sample_name(m.name + '_sum', labels)} "
                             f"{m.sum!r}")
                lines.append(f"{sample_name(m.name + '_count', labels)} "
                             f"{m.count}")
            else:
                family(m.name, m.kind, m.help)
                lines.append(f"{sample_name(m.name, labels)} "
                             f"{float(m.value)!r}")
        for prefix, fn in self._sources:
            try:
                vals = dict(fn())
            except Exception:
                continue
            for k, v in vals.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)) \
                        or not math.isfinite(float(v)):
                    continue
                name = f"{prefix}_{k}"
                family(name, "gauge", "")
                lines.append(f"{name} {float(v)!r}")
        return "\n".join(lines) + "\n"
