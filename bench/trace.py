"""A traced span of the serving loop and what the metrics read from it.

``traced_span`` runs the loop for a few seconds under ``torch.profiler``
(host and device activity). The span leads with a marker kernel
(``torch.cuda._sleep``'s spin kernel) and counts only the device events
that start after the marker ends on the device clock, since a trace can
lose its first events and its host and device clocks can sit apart. The
kernels' wrappers count their launches (graph replays included), so a
trace that holds fewer events of a counted kernel than were launched is
known to be short: ``Trace.complete`` says which kernels it holds whole.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MARK_NAME = "spin_kernel"
MARK_CYCLES = 20000
SPAN_NAME = "bench_traced_span"

#: device events a wrapper launch makes, by the name part the kernel's
#: events carry and the wrapper counting them
KERNEL_EVENTS = {"flash_attention_": ("flash_attention", 1),
                 "decode_attention_": ("decode_attention", 2),
                 "moe_gemm_": ("moe_gemm", 2)}


@dataclass
class Event:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    """The device events of the span, its bounds on the trace's clock,
    the loop's steps inside it, and the launches the wrappers counted."""
    device: List[Event]
    host: List[Event]
    start_ns: int
    end_ns: int
    steps: list
    launches: Dict[str, int]
    complete: Dict[str, bool] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device events' intervals, clipped to the
        span, in order."""
        spans = sorted((max(e.start_ns, self.start_ns),
                        min(e.end_ns, self.end_ns)) for e in self.device)
        merged: List[Tuple[int, int]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def kernel_s(self, pattern: str) -> Optional[float]:
        """Device seconds of the events whose name holds ``pattern``;
        None when the trace lost some of them or holds none."""
        if not self.complete.get(pattern, False):
            return None
        total = sum(e.end_ns - e.start_ns for e in self.device
                    if pattern in e.name)
        return total * 1e-9 if total > 0 else None

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for e in self.device:
            by[e.name[:160]] = by.get(e.name[:160], 0) + e.end_ns - e.start_ns
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10, least_ns: int = 10_000) -> List[list]:
        """The device's idle time, summed by the innermost host
        operation running at each gap's start ("python" where none
        runs); gaps under ``least_ns`` are summed as one entry. The
        largest first."""
        busy = self.busy_intervals()
        edges = [self.start_ns] + [x for ab in busy for x in ab] \
            + [self.end_ns]
        host = sorted((e for e in self.host if e.name != SPAN_NAME),
                      key=lambda e: e.start_ns)
        starts = [e.start_ns for e in host]
        small = f"gaps under {least_ns // 1000} us"
        by: Dict[str, int] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            name = small
            if b - a >= least_ns:
                name = "python"
                i = bisect.bisect_right(starts, a)
                for e in reversed(host[max(i - 500, 0):i]):
                    if e.end_ns > a:
                        name = e.name
                        break
            by[name[:160]] = by.get(name[:160], 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]


def _events(prof):
    """(device events, host events) of a finished profile, read from the
    profiler's raw results (building its event tree for a few hundred
    thousand events takes minutes)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != cuda:
            host.append(ev)
        elif not e.is_user_annotation():
            dev.append(ev)
    return dev, host


def traced_span(loop, seconds: float, device) -> Trace:
    """Run ``loop.step()`` for ``seconds`` under the profiler (host
    activity alone on the CPU, where no device event is recorded)."""
    import torch
    from repro_torch import kernels
    cuda = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    steps = []
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize(device)
        before = kernels.launch_counts()
        with torch.profiler.record_function(SPAN_NAME):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                steps.append(loop.step())
            if cuda:
                torch.cuda.synchronize(device)
        after = kernels.launch_counts()
    dev, host = _events(prof)
    marks = [e.end_ns for e in dev if MARK_NAME in e.name]
    span = [e for e in host if e.name == SPAN_NAME]
    if not cuda and span:
        marks = [span[0].start_ns]
    start = max(marks) if marks else None
    end = span[0].end_ns if span else None
    launches = {k: after[k] - before[k] for k in after}
    if start is None or end is None:
        # the marker or the span was lost: nothing in it can be trusted
        return Trace([], host, 0, 0, steps, launches)
    dev = [e for e in dev if e.start_ns >= start and MARK_NAME not in e.name]
    trace = Trace(dev, [e for e in host if e.end_ns > start], start, end,
                  steps, launches)
    for pattern, (wrapper, per_call) in KERNEL_EVENTS.items():
        seen = sum(pattern in e.name for e in dev)
        trace.complete[pattern] = seen == per_call * launches.get(wrapper, 0)
    return trace
