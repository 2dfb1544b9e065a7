"""A copy of ``repro.obs.export``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other. One addition: a recorder's device spans (``TraceRecorder(
device=True)``, timed on the card by CUDA events) go on a third track
group, process ``device``, since their clock is the card's, not the
host's ``perf_counter``: their timestamps are relative to the walk's
base event.

Chrome-trace / Perfetto JSON export of executed spans and scheduled
plans.

``chrome_trace`` renders two aligned track groups into one JSON object
in the Chrome Trace Event format (loadable in Perfetto / chrome://
tracing):

  * process ``scheduled``  — the plan's ``ScheduleResult`` intervals:
    one thread per resource lane (AG / A2E / EG / E2A), one complete
    ("X") event per task, tagged layer/mb/chunk. Modeled seconds map to
    trace microseconds at t=0.
  * process ``executed``   — a ``TraceRecorder``'s spans: one thread per
    span track (engine phases, per-lane executed tasks, per-request
    lifecycle rows), timestamps relative to the recorder's origin.

Loading both groups side by side IS the predicted-vs-executed Gantt the
overlap attributor quantifies.

``validate_chrome_trace`` is the schema gate CI runs on the artifact:
required keys per event, and per-track span sanity — events sorted by
timestamp must be disjoint or properly nested (stack discipline), which
is what makes the Perfetto rendering unambiguous.
"""
from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.obs.trace import TraceRecorder

#: fixed process ids for the two track groups
PID_EXECUTED = 1
PID_SCHEDULED = 2
PID_DEVICE = 3

_US = 1e6


def _meta(pid: int, tid: Optional[int], name_key: str, name: str) -> dict:
    ev = {"ph": "M", "pid": pid, "name": name_key,
          "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


class _TidMap:
    """Stable thread-id assignment per track name within one process."""

    def __init__(self, pid: int, events: List[dict]):
        self.pid = pid
        self.events = events
        self._tids: Dict[str, int] = {}

    def tid(self, track: str) -> int:
        t = self._tids.get(track)
        if t is None:
            t = len(self._tids)
            self._tids[track] = t
            self.events.append(_meta(self.pid, t, "thread_name", track))
        return t


def scheduled_events(result, events: Optional[List[dict]] = None,
                     pid: int = PID_SCHEDULED) -> List[dict]:
    """Complete events for a ``taskgraph.ScheduleResult``: one per task
    on its resource lane's thread, modeled seconds -> microseconds."""
    events = events if events is not None else []
    events.append(_meta(pid, None, "process_name", "scheduled"))
    tids = _TidMap(pid, events)
    for task, start, end in result.spans():
        events.append({
            "name": task.kind, "cat": "scheduled", "ph": "X",
            "ts": start * _US, "dur": (end - start) * _US,
            "pid": pid, "tid": tids.tid(task.resource),
            "args": {"kind": task.kind, "layer": task.layer,
                     "mb": task.mb, "chunk": task.chunk,
                     "lane": task.resource},
        })
    return events


def executed_events(tracer: TraceRecorder,
                    events: Optional[List[dict]] = None,
                    pid: int = PID_EXECUTED) -> List[dict]:
    """Complete events for a recorder's spans, one thread per track,
    timestamps relative to the recorder's origin."""
    return _span_events(tracer.spans, tracer.origin, "executed", events,
                        pid)


def device_events(tracer: TraceRecorder,
                  events: Optional[List[dict]] = None,
                  pid: int = PID_DEVICE) -> List[dict]:
    """Complete events for a recorder's device spans, one thread per
    track, timestamps relative to the base event on the card."""
    return _span_events(tracer.device_spans, 0.0, "device", events, pid)


def _span_events(spans, origin: float, process: str,
                 events: Optional[List[dict]], pid: int) -> List[dict]:
    events = events if events is not None else []
    events.append(_meta(pid, None, "process_name", process))
    tids = _TidMap(pid, events)
    for s in spans:
        ev = {
            "name": s.name, "cat": s.cat, "ph": "X",
            "ts": (s.start - origin) * _US,
            "dur": s.duration * _US,
            "pid": pid, "tid": tids.tid(s.track),
            "args": dict(s.args),
        }
        if s.end == s.start and s.cat == "instant":
            ev["ph"] = "i"
            ev["s"] = "t"
            del ev["dur"]
        events.append(ev)
    return events


def chrome_trace(tracer: Optional[TraceRecorder] = None,
                 schedule=None,
                 meta: Optional[Mapping] = None) -> dict:
    """The full trace object: executed and/or scheduled track groups,
    and the device group when the recorder holds device spans."""
    events: List[dict] = []
    if schedule is not None:
        scheduled_events(schedule, events)
    if tracer is not None:
        executed_events(tracer, events)
        if tracer.device_spans:
            device_events(tracer, events)
    obj = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        obj["otherData"] = dict(meta)
    return obj


def export_chrome_trace(path, tracer: Optional[TraceRecorder] = None,
                        schedule=None,
                        meta: Optional[Mapping] = None) -> dict:
    """Write ``chrome_trace(...)`` to ``path``; returns the object."""
    obj = chrome_trace(tracer=tracer, schedule=schedule, meta=meta)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


# ---------------------------------------------------------------------------
# validation (the CI schema gate)
# ---------------------------------------------------------------------------

_X_REQUIRED = ("name", "ts", "dur", "pid", "tid")


def validate_chrome_trace(obj, eps_us: float = 0.5) -> Dict[str, int]:
    """Validate a trace object (or JSON string): top-level shape, the
    required keys per complete event, and per-(pid, tid) track
    discipline — spans sorted by start must be disjoint or properly
    nested; partial overlap within a track is a schema error. Returns
    counting stats; raises ValueError on any violation.

    ``eps_us`` absorbs float rounding at span edges (microseconds).
    """
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    tracks: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    n_complete = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"event {i}: not an object with 'ph'")
        ph = ev["ph"]
        if ph in ("M", "i", "I"):
            continue
        if ph != "X":
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
        for k in _X_REQUIRED:
            if k not in ev:
                raise ValueError(f"event {i}: missing key {k!r}")
        ts, dur = float(ev["ts"]), float(ev["dur"])
        if dur < 0:
            raise ValueError(f"event {i}: negative duration {dur}")
        tracks.setdefault((ev["pid"], ev["tid"]), []).append((ts, ts + dur))
        n_complete += 1
    for (pid, tid), spans in tracks.items():
        spans.sort()
        stack: List[Tuple[float, float]] = []
        for s, e in spans:
            while stack and s >= stack[-1][1] - eps_us:
                stack.pop()
            if stack and e > stack[-1][1] + eps_us:
                raise ValueError(
                    f"track (pid={pid}, tid={tid}): span [{s}, {e}] "
                    f"partially overlaps [{stack[-1][0]}, {stack[-1][1]}]")
            stack.append((s, e))
    return {"events": len(events), "complete": n_complete,
            "tracks": len(tracks)}
