"""Span tracing (PyTorch counterpart of ``repro.obs.trace``): host spans
on a monotonic clock and, on a CUDA device, task spans timed on the card
by event pairs.

A ``Span`` is (name, track, cat, start, end, args); a ``TraceRecorder``
is an append-only list of them plus the clock that stamps them. Three
span families, as in the reference:

  * ``cat="phase"``   engine step phases (admit / prefill_chunk /
                      decode_step), opened by the engine's host loop
                      around model calls that end in a device sync;
  * ``cat="task"``    one span per task of the DEP walk (SHARED/A2E/EXP/
                      E2A/REP), tagged kind/layer/mb/chunk/lane. The
                      walker records the host *emission* of each task
                      (``args["emit"]=True``): in an eager walk the time
                      the host took to enqueue it; under a CUDA graph
                      capture once per captured program, as the
                      reference's spans record once per compiled program;
  * ``cat="request"`` request lifecycle segments (queued / prefill /
                      decode) from a finished request's timestamps.

A recorder built with ``device=True`` also times each task on the card:
a ``torch.cuda.Event(enable_timing=True)`` pair on the stream that runs
the task (the comm stream for A2E/E2A, the compute stream for the rest),
measured from a base event recorded on the compute stream before the
walk. ``resolve_device_spans()`` waits once for the card and turns the
pairs into executed spans (``emit=False``) in ``device_spans``, whose
clock is the card's, seconds after the base event: they never mix with
the host spans in ``spans``. This is the port's form of the reference's
fenced walk, and it does not serialise the two streams. No event is
recorded while the current stream is capturing a CUDA graph.

The *active tracer* is a context variable: the engine scopes it around
its model calls (``use_tracer``), and ``core.dep``'s walker asks
``active_tracer()`` once per walk. With no tracer set (or a disabled
one) the walker is the bare loop.

``fence=True`` makes the walker wait, after each task, for the stream
that ran it (``maybe_fence``), so that host task spans bound device work;
it does nothing on the CPU.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class Span:
    """One traced interval. ``start``/``end`` are seconds on the
    recorder's clock (``end == start`` for instant events), or for a
    device span seconds after the walk's base event."""

    name: str
    track: str
    start: float
    end: float
    cat: str = "phase"
    args: Tuple[Tuple[str, Any], ...] = ()

    @property
    def duration(self) -> float:
        return self.end - self.start

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default


def _task_args(task, **args) -> Dict[str, Any]:
    return dict(kind=task.kind, layer=task.layer, mb=task.mb,
                chunk=task.chunk, lane=task.resource, **args)


def wait_for(x, stream: Optional[torch.cuda.Stream] = None) -> None:
    """Wait until ``stream`` (default: the current stream of the CUDA
    device the tensor ``x`` lies on) has run everything enqueued so far.
    Nothing for a CPU tensor or a value that is not a tensor."""
    if stream is not None:
        stream.synchronize()
    elif isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


class TraceRecorder:
    """Append-only span sink on one monotonic clock.

    ``enabled=False`` turns every hook into a no-op (the engine keeps the
    object wired so flipping tracing on needs no re-plumbing).
    ``origin`` is the construction timestamp exports are made relative
    to, so multiple recorders/export groups align. ``device=True`` times
    the DEP walk's tasks on the card as well (see the module docstring).
    """

    def __init__(self, enabled: bool = True, fence: bool = False,
                 clock=time.perf_counter, device: bool = False):
        self.enabled = enabled
        self.fence = fence
        self.device = device
        self.clock = clock
        self.origin = clock()
        self.spans: List[Span] = []
        self.device_spans: List[Span] = []
        self.dropped = 0
        self._base: Optional[torch.cuda.Event] = None
        # (task, stream label, start event, end event) in record order
        self._pending: List[tuple] = []

    # -- recording ------------------------------------------------------
    def add_span(self, name: str, track: str, start: float, end: float,
                 cat: str = "phase", **args) -> None:
        if not self.enabled:
            return
        self.spans.append(Span(name=name, track=track, start=start,
                               end=end, cat=cat,
                               args=tuple(sorted(args.items()))))

    @contextmanager
    def span(self, name: str, track: str = "engine", cat: str = "phase",
             **args):
        """Time a block: records one span on exit (even on error)."""
        if not self.enabled:
            yield self
            return
        t0 = self.clock()
        try:
            yield self
        finally:
            self.add_span(name, track, t0, self.clock(), cat=cat, **args)

    def instant(self, name: str, track: str = "engine",
                cat: str = "instant", **args) -> None:
        if not self.enabled:
            return
        t = self.clock()
        self.add_span(name, track, t, t, cat=cat, **args)

    def task_span(self, task, start: float, end: float,
                  emit: bool = False, **args) -> None:
        """One span for an executed (or emitted) IR task, tagged with the
        graph coordinates the overlap attributor groups by."""
        self.add_span(task.kind, task.resource, start, end, cat="task",
                      **_task_args(task, emit=emit, **args))

    def request_lifecycle(self, req, finish_t: Optional[float] = None
                          ) -> None:
        """Record a finished request's lifecycle segments from its
        timestamps: queued (submit -> admit), prefill (admit -> first
        token), decode (first token -> finish). Missing stamps collapse
        their segment."""
        if not self.enabled:
            return
        finish = finish_t if finish_t is not None else \
            (req.finish_t if req.finish_t is not None else self.clock())
        track = f"req-{req.request_id}"
        admit = req.admit_t if getattr(req, "admit_t", None) is not None \
            else finish
        first = req.first_token_t if req.first_token_t is not None \
            else finish
        rid = req.request_id
        state = getattr(req.state, "value", str(req.state))
        self.add_span("queued", track, req.arrival_t, admit,
                      cat="request", request_id=rid, state=state)
        if admit < first:
            self.add_span("prefill", track, admit, first, cat="request",
                          request_id=rid, state=state)
        if first < finish:
            self.add_span("decode", track, first, finish, cat="request",
                          request_id=rid, state=state,
                          tokens=len(req.output))

    # -- device timing --------------------------------------------------
    def times_device(self, stream: Optional[torch.cuda.Stream]) -> bool:
        """Whether tasks run on ``stream`` are timed on the card now: a
        device-mode recorder, a CUDA stream, and no graph capture under
        way (an event recorded in a capture would not time a replay)."""
        return (self.enabled and self.device and stream is not None
                and not torch.cuda.is_current_stream_capturing())

    def device_base(self, stream: torch.cuda.Stream) -> None:
        """Record the base event the device spans are measured from, on
        ``stream`` (the compute stream, before the walk), unless one is
        already recorded."""
        if self._base is None and self.times_device(stream):
            self._base = torch.cuda.Event(enable_timing=True)
            self._base.record(stream)

    def base_reached(self) -> Optional[bool]:
        """Whether the card has reached the base event (None before one
        is recorded): False right after the host enqueued a walk means
        the card was still behind the host, so no span holds a wait for
        the host."""
        return None if self._base is None else self._base.query()

    @contextmanager
    def device_task(self, task, stream: Optional[torch.cuda.Stream],
                    label: str = "compute"):
        """Time the work the block enqueues on ``stream`` for ``task``:
        an event pair around it. Does nothing unless ``times_device``."""
        if not self.times_device(stream):
            yield
            return
        self.device_base(stream)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        self._pending.append((task, label, start, end))

    def resolve_device_spans(self) -> List[Span]:
        """Wait for the card once, turn every pending event pair into an
        executed task span (seconds after the base event, ``emit=False``,
        track ``"device:<lane>"``) appended to ``device_spans``, and
        return the new spans in record order."""
        if not self._pending:
            return []
        torch.cuda.synchronize()
        new = []
        for task, label, start, end in self._pending:
            new.append(Span(
                name=task.kind, track=f"device:{task.resource}",
                start=self._base.elapsed_time(start) / 1e3,
                end=self._base.elapsed_time(end) / 1e3, cat="task",
                args=tuple(sorted(_task_args(
                    task, emit=False, stream=label).items()))))
        self._pending = []
        self.device_spans.extend(new)
        return new

    # -- fencing --------------------------------------------------------
    def maybe_fence(self, x, stream: Optional[torch.cuda.Stream] = None
                    ) -> None:
        """Opt-in task fence: wait for the stream that produced ``x``
        (``stream``, or the current stream of its device) so that the
        enclosing host span bounds device work, not the enqueue. No-op
        unless this recorder was built with ``fence=True``, and on the
        CPU."""
        if self.enabled and self.fence and x is not None:
            wait_for(x, stream)

    # -- readers --------------------------------------------------------
    def task_spans(self, emitted: Optional[bool] = None) -> List[Span]:
        """Task-category host spans; ``emitted`` filters emission records
        (True), executed spans (False), or returns both (None). Device
        spans are in ``device_spans``."""
        out = [s for s in self.spans if s.cat == "task"]
        if emitted is None:
            return out
        return [s for s in out if bool(s.arg("emit")) == emitted]

    def by_cat(self, cat: str) -> List[Span]:
        return [s for s in self.spans if s.cat == cat]

    def clear(self) -> None:
        self.spans = []
        self.device_spans = []
        self._pending = []
        self._base = None
        self.dropped = 0
        self.origin = self.clock()

    def __len__(self) -> int:
        return len(self.spans)

    def __repr__(self) -> str:
        cats: Dict[str, int] = {}
        for s in self.spans:
            cats[s.cat] = cats.get(s.cat, 0) + 1
        if self.device_spans:
            cats["device"] = len(self.device_spans)
        body = ", ".join(f"{k}={v}" for k, v in sorted(cats.items()))
        state = "on" if self.enabled else "off"
        return f"TraceRecorder({state}; {body or 'empty'})"


# ---------------------------------------------------------------------------
# active-tracer scoping (how the executor finds the engine's recorder)
# ---------------------------------------------------------------------------

_ACTIVE: ContextVar[Optional[TraceRecorder]] = ContextVar(
    "repro_torch_obs_active_tracer", default=None)


def active_tracer() -> Optional[TraceRecorder]:
    """The recorder scoped by the innermost ``use_tracer`` (None when
    none is scoped or it is disabled) — what ``core.dep``'s task walk
    consults. Must stay cheap: it runs once per executor walk."""
    t = _ACTIVE.get()
    return t if (t is not None and t.enabled) else None


@contextmanager
def use_tracer(tracer: Optional[TraceRecorder]):
    """Scope ``tracer`` as the active tracer for the block (None scopes
    tracing OFF, shadowing any outer tracer)."""
    token = _ACTIVE.set(tracer)
    try:
        yield tracer
    finally:
        _ACTIVE.reset(token)
