"""Execute a scheduled task graph for real on host lanes (PyTorch
counterpart of ``repro.obs.replay``; the same as it except the payload
fence, which waits for the CUDA stream that produced the payload's
value, ``obs.trace.wait_for``, and does nothing for a CPU value).

The overlap attributor needs genuinely *executed* spans — real
wall-clock concurrency across the four resource lanes. This module runs
a ``ScheduleResult`` on one worker thread per resource lane
(AG / A2E / EG / E2A), honoring the IR's dependency edges with real
synchronization, and records one executed ``cat="task"`` span per task
into a ``TraceRecorder``.

Mechanics:

  * each lane thread serves its tasks in the graph's emission order
    (the same FIFO discipline the scheduler models);
  * every task owns a ``threading.Event`` set at completion; a task
    begins only after all its deps' events — cross-lane waits are real
    blocking waits, so overlap/serialization emerges from execution,
    not from replaying the modeled start times;
  * each task then occupies its lane for ``duration * time_scale``
    wall seconds (sleep for the bulk, spin the tail — ``time.sleep``
    releases the GIL, the short spin gives sub-ms edge accuracy);
  * ``payloads`` optionally maps a kind class to a thunk returning a
    tensor that is waited for inside the span, so the harness can also
    exercise real device work per task.

Durations are time-scaled so the whole replay runs in a fraction of a
second regardless of the modeled makespan; ``attribute_overlap`` is
scale-free on its headline gap metric and de-scales absolute seconds.

Fidelity bound: the GIL serializes the *bookkeeping* between tasks but
not the sleeps, so with default scaling executed lane occupancy tracks
the model to a few percent of makespan — the tests assert a generous
eps, not equality.
"""
from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.taskgraph import (_KIND_IDX, KIND_CLASS, RESOURCES,
                                        ScheduleResult, TaskCosts, TaskGraph,
                                        schedule)
from repro_torch.obs.trace import Span, TraceRecorder, wait_for

#: wall-clock length (seconds) a replay aims for when auto-scaling
DEFAULT_MAX_WALL_S = 0.4
#: never stretch a fast plan beyond this factor (keeps tiny graphs fast)
_MAX_SCALE = 1e7
#: spin (not sleep) the last stretch of each task for edge accuracy
_SPIN_TAIL_S = 2e-4


@dataclass
class ReplayResult:
    """Executed spans plus the schedule they replayed.

    ``spans`` are in recorder order (wall-clock seconds, SCALED — divide
    by ``time_scale`` to compare against the modeled schedule; the
    attributor does this). ``wall_s`` is the measured replay makespan.
    """

    spans: List[Span]
    scheduled: ScheduleResult
    time_scale: float
    wall_s: float


def _occupy_until(clock, deadline: float) -> None:
    """Hold the lane until ``deadline``: sleep the bulk (releases the
    GIL so other lanes run), spin the tail for edge accuracy."""
    while True:
        rem = deadline - clock()
        if rem <= 0:
            return
        if rem > _SPIN_TAIL_S:
            time.sleep(rem - _SPIN_TAIL_S)
        # tail: busy-wait
        while clock() < deadline:
            pass
        return


def replay_schedule(graph: TaskGraph, costs: TaskCosts, *,
                    tracer: Optional[TraceRecorder] = None,
                    time_scale: Optional[float] = None,
                    max_wall_s: float = DEFAULT_MAX_WALL_S,
                    payloads: Optional[Dict[str, Callable[[], object]]]
                    = None,
                    order: Optional[Sequence[int]] = None,
                    extra_deps: Optional[Dict[int, Tuple[int, ...]]]
                    = None) -> ReplayResult:
    """Schedule ``graph`` under ``costs`` and execute it on one worker
    thread per resource lane. Returns the executed spans alongside the
    schedule they should match.

    ``time_scale`` multiplies every modeled duration into wall seconds;
    by default it is chosen so the replay takes ~``max_wall_s``.
    ``payloads`` maps a ``KIND_CLASS`` value ("gemm"/"attn"/"comm") to a
    zero-arg callable whose tensor result is waited for inside the
    task's span.

    ``order`` overrides the per-lane FIFO service order (a permutation
    of task indices; each lane serves its tasks in this order instead of
    emission order) and ``extra_deps`` adds dependency edges
    {task index: (must-complete-first indices, ...)} on top of the IR's.
    Together they realize ALTERNATE executors of the same graph — e.g.
    ``taskgraph.stream_major_order`` + ``taskgraph.stream_serial_deps``
    replay the sequential (non-interleaved) micro-batch walk so its
    executed overlap can be compared against the interleaved one. The
    returned ``scheduled`` is always the unconstrained schedule — the
    target the executed spans are attributed against.
    """
    sched = schedule(graph, costs)
    if time_scale is None:
        ms = sched.makespan
        time_scale = min(max_wall_s / ms, _MAX_SCALE) if ms > 0 else 1.0
    rec = tracer if tracer is not None else TraceRecorder()
    clock = rec.clock

    tasks = graph.tasks
    done = [threading.Event() for _ in tasks]
    by_lane: Dict[str, List[int]] = {r: [] for r in RESOURCES}
    service = order if order is not None else range(len(tasks))
    for i in service:
        by_lane[tasks[i].resource].append(i)
    extra = extra_deps or {}
    durs = costs.per_kind(graph)
    errors: List[BaseException] = []

    def lane_worker(lane: str) -> None:
        try:
            for i in by_lane[lane]:
                task = tasks[i]
                for d in task.deps:
                    done[d].wait()
                for d in extra.get(i, ()):
                    done[d].wait()
                t0 = clock()
                if payloads:
                    thunk = payloads.get(KIND_CLASS[task.kind])
                    if thunk is not None:
                        wait_for(thunk())
                dur = durs[_KIND_IDX[task.kind]] * time_scale
                if dur > 0:
                    _occupy_until(clock, t0 + dur)
                rec.task_span(task, t0, clock(), emit=False)
                done[i].set()
        except BaseException as e:   # surface to caller, don't deadlock
            errors.append(e)
            for i in by_lane[lane]:
                done[i].set()

    # a short switch interval tightens cross-thread wakeup latency while
    # lanes hand off; restore the default afterwards
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(5e-5)
    t_start = clock()
    threads = [threading.Thread(target=lane_worker, args=(r,),
                                name=f"replay-{r}", daemon=True)
               for r in RESOURCES if by_lane[r]]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(old_switch)
    if errors:
        raise errors[0]
    wall = clock() - t_start
    spans = [s for s in rec.task_spans(emitted=False)]
    return ReplayResult(spans=spans, scheduled=sched,
                        time_scale=time_scale, wall_s=wall)
