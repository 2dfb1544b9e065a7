"""A copy of ``repro.core.taskgraph``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Task-graph execution IR: ONE lowering from a solved ``Plan`` to typed
tasks, shared by the simulator, the DEP executor, and telemetry.

FinDEP's core contribution is partitioning the DEP step into fine-grained
tasks and scheduling them (paper Section 3). Before this module, the repo
interpreted a ``Plan`` (r1, r2, m_a, m_e, shared-expert order) three
independent times: the event simulator rebuilt the task timeline
analytically, ``core.dep`` re-derived the execution order imperatively,
and telemetry could only attribute residuals at whole-step granularity.
Now all three consume the same structure:

    lower(plan, spec)  ->  TaskGraph          (the single lowering)
      |-- schedule(graph, TaskCosts)          exact event-order makespan
      |         (repro.core.simulator wraps this as simulate_dep/naive/
      |          pppipe -- baselines are alternate LOWERINGS, not
      |          separate simulators)
      |-- graph.exec_walk()                   program-order task stream
      |         the DEP executor (repro.core.dep) maps each task kind to
      |         jax ops: A2E/E2A -> chunked all_to_all, EXP -> expert
      |         FFN, SHARED -> shared-expert GEMM segment, GATE -> router
      |         dispatch
      `-- ScheduleResult.kind_busy()          per-primitive cost tags
                telemetry (repro.profiling) attributes measured residuals
                to GEMM vs attention vs comm instead of uniformly
                rescaling the whole profile

Task kinds and resources
------------------------

    kind      resource  class      meaning (paper Section 3.2)
    ATTN      AG        attn       attention segment, m_a samples
    SHARED    AG        gemm       shared-expert GEMM segment
    GATE      AG        gemm       router dispatch (zero-cost in the
                                   analytic model; folded into t_a)
    A2E       A2E       comm       dispatch all_to_all for one chunk
    EXP       EG        gemm       routed-expert FFN for one chunk
    E2A       E2A       comm       combine all_to_all for one chunk
    REP       AG        gemm       replicated hot-expert FFN on the
                                   locally resident tokens (placement
                                   subsystem; absent when hot_experts=0)

A ``Task`` is pure STRUCTURE (no durations): two plans that compile to
the same program lower to equal graphs, so a ``TaskGraph`` is a valid
jit static argument. Durations come from ``TaskCosts`` at schedule time.

Lowering rules (ASAS order, FinDEP semantics):

    A(t,i)        on AG, after max(e2a(t-1,i,last), shared(t-1,i,last))
    GATE(t,i)     on AG, after A(t,i)                    (zero cost)
    S(t,i,k)      on AG, after A(t,i); ASAS splits the shared expert
                  into r2 segments (one per chunk boundary -- what the
                  executor emits); AASS keeps one whole-batch task at
                  boundary 0
    a2e(t,i,j)    on A2E link, after A(t,i) + GATE(t,i); under
                  ``shared_blocks_a2e`` (naive / PPPipe lowerings) also
                  after the last shared segment
    E(t,i,j)      on EG, after a2e(t,i,j)
    e2a(t,i,j)    on E2A link, after E(t,i,j)

Mutual exclusion per resource (Eq. 5 rules 1-5) holds because every
resource serves its tasks in the graph's emission order (AG in the
policy order, links and EG FIFO by (t, i, j)); with that order fixed,
completion times follow a forward recurrence and ``schedule`` is exact
and O(#tasks) -- no event heap.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Dict, List, Optional, Tuple

from repro_torch.core.analytic import ORDER_AASS, ORDER_ASAS, StageTimes

# -- task kinds -------------------------------------------------------------
ATTN = "ATTN"
SHARED = "SHARED"
GATE = "GATE"
A2E = "A2E"
EXP = "EXP"
E2A = "E2A"
REP = "REP"
# REP is appended so the positional kind indices of the original six
# kinds (and every per_kind tuple built against them) stay stable.
KINDS = (ATTN, SHARED, GATE, A2E, EXP, E2A, REP)

# -- resources (scheduling lanes) and their classes -------------------------
RESOURCES = ("AG", "A2E", "EG", "E2A")
#: coarse resource classes used for telemetry attribution
RESOURCE_CLASS = {"AG": "compute_a", "EG": "compute_e",
                  "A2E": "comm", "E2A": "comm"}
#: hardware-primitive class per task kind (which alpha-beta model a task's
#: duration comes from -- the tag drift attribution retunes against)
KIND_CLASS = {ATTN: "attn", SHARED: "gemm", GATE: "gemm", EXP: "gemm",
              A2E: "comm", E2A: "comm", REP: "gemm"}
KIND_RESOURCE = {ATTN: "AG", SHARED: "AG", GATE: "AG",
                 A2E: "A2E", EXP: "EG", E2A: "E2A", REP: "AG"}

Interval = Tuple[float, float]


@dataclass(frozen=True)
class Task:
    """One typed node of the execution IR.

    ``chunk`` is the r2 chunk index for A2E/EXP/E2A; for SHARED it is the
    chunk *boundary* at which the executor emits the segment (ASAS: one
    segment per boundary; AASS: the whole shared expert at boundary 0).
    ``deps`` are indices into ``TaskGraph.tasks`` and always point to
    earlier positions (the tuple is topologically ordered by
    construction)."""

    kind: str
    layer: int                     # t  < T
    mb: int                        # micro-batch i < r1
    chunk: int = 0                 # j  < r2 (see above for SHARED)
    deps: Tuple[int, ...] = ()

    @property
    def resource(self) -> str:
        return KIND_RESOURCE[self.kind]

    def describe(self) -> str:
        """Human-readable identity for error messages and reports."""
        return (f"{self.kind}(layer={self.layer}, mb={self.mb}, "
                f"chunk={self.chunk})")


@dataclass(frozen=True)
class LoweringSpec:
    """Everything a lowering needs beyond the plan itself.

    ``T`` is the number of MoE layers the graph spans; ``has_shared``
    drops SHARED tasks for models without a shared expert;
    ``shared_blocks_a2e`` is the naive/PPPipe semantics where dispatch
    waits for the shared expert (FinDEP's independence is the default).
    ``r1``/``r2`` override the plan's values -- ``EXEC_SPEC`` uses
    ``T=1, r1=1`` because the executor's unit of work is one micro-batch
    of one layer (the caller's batching realizes r1; the transformer
    loop realizes T)."""

    T: int
    has_shared: bool = True
    shared_blocks_a2e: bool = False
    r1: Optional[int] = None
    r2: Optional[int] = None


#: the executor's view: one micro-batch of one layer
EXEC_SPEC = LoweringSpec(T=1, r1=1)


@dataclass(frozen=True)
class TaskGraph:
    """Immutable, hashable task graph. The graph's STRUCTURE is a pure
    function of its lowering parameters, so those scalars ARE the
    identity (O(1) hash/eq — cheap jit static argument); the emitted
    task list and the scheduler's compact program are derived lazily and
    cached per (lru-cached) instance.

    ``tasks`` is emission-ordered: per layer, the AG sequence in the
    policy order, then the chunk stream FIFO by (i, j) — the order every
    resource serves its tasks in.

    ``m_e`` is the solver's per-expert chunk granularity (tokens per
    expert per chunk, floored); the executor aligns its capacity to
    ``r2 * m_e`` so the chunks it runs are the ones the solver modeled.

    ``hot_experts`` is the number of replicated (hot) experts under the
    active ``placement.Placement``: when > 0 the lowering emits one REP
    task per (layer, mb) on the AG lane — the locally-resident hot FFN
    work that skips the A2E/E2A wire. ``placement_epoch`` carries the
    placement generation into the graph identity (hash/eq) so jit static
    args and ``PlanCache`` entries keyed on the graph can never serve a
    stale replica layout; the epoch does NOT change the emitted
    structure. Both default to 0, which lowers bit-identically to the
    pre-placement graphs.
    """

    T: int
    r1: int
    r2: int
    order: str
    m_e: int = 1
    has_shared: bool = True
    shared_blocks_a2e: bool = False
    hot_experts: int = 0
    placement_epoch: int = 0

    @property
    def shared_segments(self) -> int:
        """Segments the shared expert is split into per (layer, mb)."""
        return self.r2 if self.order == ORDER_ASAS else 1

    @cached_property
    def _emitted(self) -> Tuple[Tuple[int, int, int, int, Tuple[int, ...]],
                                ...]:
        """Compact emission records (kind_idx, layer, mb, chunk, deps) —
        the single source both ``tasks`` and ``_program`` derive from."""
        return tuple(_emit_structure(self.T, self.r1, self.r2, self.order,
                                     self.has_shared,
                                     self.shared_blocks_a2e,
                                     self.hot_experts))

    @cached_property
    def tasks(self) -> Tuple[Task, ...]:
        return tuple(Task(KINDS[k], t, i, c, deps)
                     for k, t, i, c, deps in self._emitted)

    @cached_property
    def _program(self) -> Tuple[Tuple[int, int, Tuple[int, ...]], ...]:
        """(resource_idx, kind_idx, deps) triples for the scheduler's
        inner loop."""
        return tuple((_KIND_RESOURCE_IDX[k], k, deps)
                     for k, _, _, _, deps in self._emitted)

    def tasks_of(self, kind: str, layer: Optional[int] = None,
                 mb: Optional[int] = None) -> List[Tuple[int, Task]]:
        return [(i, t) for i, t in enumerate(self.tasks)
                if t.kind == kind
                and (layer is None or t.layer == layer)
                and (mb is None or t.mb == mb)]

    def exec_walk(self, mb: int = 0) -> Tuple[Task, ...]:
        """The (layer 0, micro-batch ``mb``) slice in executed PROGRAM
        order: GATE, the REP task when the placement replicates hot
        experts, then per chunk j: A2E(j), SHARED segments at boundary j,
        EXP(j), E2A(j) (under ``shared_blocks_a2e`` the boundary-j shared
        segments precede A2E(j) — dispatch waits for them). This is the
        op-emission order ``repro.core.dep`` walks, and it matches the
        hand-rolled loops it replaced op for op."""
        slice_ = [t for t in self.tasks if t.layer == 0 and t.mb == mb]
        by_kind: Dict[str, Dict[int, Task]] = {}
        for t in slice_:
            by_kind.setdefault(t.kind, {})[t.chunk] = t
        walk: List[Task] = []
        if GATE in by_kind:
            walk.append(by_kind[GATE][0])
        if REP in by_kind:
            walk.append(by_kind[REP][0])
        for j in range(self.r2):
            shared_j = ([by_kind[SHARED][j]]
                        if j in by_kind.get(SHARED, {}) else [])
            if self.shared_blocks_a2e:
                walk.extend(shared_j)
            walk.append(by_kind[A2E][j])
            if not self.shared_blocks_a2e:
                walk.extend(shared_j)
            walk.append(by_kind[EXP][j])
            walk.append(by_kind[E2A][j])
        return tuple(walk)

    def exec_streams(self) -> Tuple[Tuple[Task, ...], ...]:
        """The layer-0 walk grouped by ``Task.mb``: one program-order
        stream per micro-batch (r1 entries, each an ``exec_walk(mb)``).
        Streams carry no cross-stream DATA deps — each stream's tasks
        only depend on its own (the router dispatch runs once over the
        whole chunk; streams are a capacity split, see ``ExecProgram``) —
        so any dep-respecting interleave of the streams computes the same
        values. The *resource* constraints across streams (AG/link/EG
        lanes are shared) are explicit in the emitted graph:
        ``stream_serial_deps`` derives the cross-stream serialization
        edges that model the sequential executor, while the scheduled
        interleave honors only the true per-stream edges."""
        return tuple(self.exec_walk(mb=i) for i in range(self.r1))

    def exec_interleaved(self,
                         hints: Optional[Tuple[int, ...]] = None
                         ) -> Tuple[Task, ...]:
        """All streams' walk tasks in SCHEDULED start order — the
        collective-matmul-style emission where micro-batch i+1's GATE
        group is issued before micro-batch i's E2A retires.

        ``hints`` are per-task priority ranks indexed by emission order
        (``ScheduleResult.priority_hints()``); when ``None`` the graph is
        scheduled under ``_HINT_COSTS`` (fixed shape-typical cost ratios
        — only the relative order matters). Because a schedule never
        starts a task before its deps end, sorting by (hint, emission
        index) is always a valid topological interleave; ATTN tasks are
        excluded (attention runs outside the MoE layer, as in
        ``exec_walk``)."""
        if hints is None:
            hints = schedule(self, _HINT_COSTS).priority_hints()
        n = len(self.tasks)
        if len(hints) != n:
            raise ValueError(
                f"hints length {len(hints)} != task count {n}")
        order = sorted(range(n), key=lambda i: (hints[i], i))
        pos = {idx: p for p, idx in enumerate(order)}
        for idx in order:
            for d in self.tasks[idx].deps:
                if pos[d] > pos[idx]:
                    task, dep = self.tasks[idx], self.tasks[d]
                    raise ValueError(
                        f"hints are not dep-consistent: "
                        f"{task.describe()} [emission {idx}, hint "
                        f"{hints[idx]}, interleaved position {pos[idx]}] "
                        f"would run before its dependency "
                        f"{dep.describe()} [emission {d}, hint "
                        f"{hints[d]}, interleaved position {pos[d]}]")
        return tuple(self.tasks[i] for i in order
                     if self.tasks[i].layer == 0
                     and self.tasks[i].kind != ATTN)

    def validate(self) -> None:
        """Deps must point backwards (topological emission order)."""
        for i, t in enumerate(self.tasks):
            for d in t.deps:
                if not 0 <= d < i:
                    raise ValueError(
                        f"task {i} ({t.kind}) dep {d} is not earlier")


_KIND_IDX = {k: i for i, k in enumerate(KINDS)}
_KIND_RESOURCE_IDX = tuple(RESOURCES.index(KIND_RESOURCE[k]) for k in KINDS)
_ATTN_I, _SHARED_I, _GATE_I = (_KIND_IDX[ATTN], _KIND_IDX[SHARED],
                               _KIND_IDX[GATE])
_A2E_I, _EXP_I, _E2A_I = _KIND_IDX[A2E], _KIND_IDX[EXP], _KIND_IDX[E2A]
_REP_I = _KIND_IDX[REP]


# ---------------------------------------------------------------------------
# The single lowering
# ---------------------------------------------------------------------------


def lower(plan, spec: LoweringSpec, hot_experts: int = 0,
          placement_epoch: int = 0) -> TaskGraph:
    """Lower a solved ``Plan`` (anything with r1/r2/order and optionally
    m_e) to a ``TaskGraph`` under ``spec``. THE single Plan->structure
    translation: the simulator schedules this graph, the executor walks
    it, telemetry tags against it. ``hot_experts``/``placement_epoch``
    carry the active expert placement (replica-aware lowering)."""
    r1 = spec.r1 if spec.r1 is not None else max(int(plan.r1), 1)
    r2 = spec.r2 if spec.r2 is not None else max(int(plan.r2), 1)
    m_e = getattr(plan, "m_e", 1) or 1
    return _lower_structure(T=spec.T, r1=r1, r2=r2, order=plan.order,
                            has_shared=spec.has_shared,
                            shared_blocks_a2e=spec.shared_blocks_a2e,
                            m_e=max(int(m_e), 1),
                            hot_experts=max(int(hot_experts), 0),
                            placement_epoch=int(placement_epoch))


def lower_exec(r2: int, order: str, m_e: int = 1, hot_experts: int = 0,
               placement_epoch: int = 0, r1: int = 1) -> TaskGraph:
    """The executor's graph for a schedule (r2, order, m_e): one layer,
    shared tasks present — the walker skips them when the model has no
    shared expert. ``r1`` > 1 lowers the layer as r1 micro-batch streams
    for the interleaved executor (``ExecProgram``); the default single
    stream is ``EXEC_SPEC``'s historical unit of work."""
    return _lower_structure(T=1, r1=max(int(r1), 1), r2=max(int(r2), 1),
                            order=order,
                            has_shared=True, shared_blocks_a2e=False,
                            m_e=max(int(m_e), 1),
                            hot_experts=max(int(hot_experts), 0),
                            placement_epoch=int(placement_epoch))


@lru_cache(maxsize=4096)
def _lower_structure(T: int, r1: int, r2: int, order: str, has_shared: bool,
                     shared_blocks_a2e: bool, m_e: int = 1,
                     hot_experts: int = 0,
                     placement_epoch: int = 0) -> TaskGraph:
    if order not in (ORDER_ASAS, ORDER_AASS):
        raise ValueError(f"unknown order {order!r}")
    assert T >= 1 and r1 >= 1 and r2 >= 1
    return TaskGraph(T=T, r1=r1, r2=r2, order=order, m_e=m_e,
                     has_shared=has_shared,
                     shared_blocks_a2e=shared_blocks_a2e,
                     hot_experts=hot_experts,
                     placement_epoch=placement_epoch)


def _emit_structure(T: int, r1: int, r2: int, order: str, has_shared: bool,
                    shared_blocks_a2e: bool, hot_experts: int = 0):
    """Yield (kind_idx, layer, mb, chunk, deps) in emission order — the
    lowering rules of the module docstring, in compact form.

    With ``hot_experts > 0`` one REP task per (layer, mb) follows GATE on
    the AG lane: the replicated hot-expert FFN runs on locally resident
    tokens, so A2E does NOT wait for it (same independence as the shared
    expert) but the next layer's attention does (it needs the combined
    output)."""
    n_seg = r2 if order == ORDER_ASAS else 1
    rep = hot_experts > 0
    idx = 0
    prev_e2a = [-1] * r1      # last e2a of (t-1, i)
    prev_sha = [-1] * r1      # last AG task (shared/REP/A) of (t-1, i)
    for t in range(T):
        a_id = [-1] * r1
        gate_id = [-1] * r1
        rep_id = [-1] * r1
        sha_last = [-1] * r1
        records = []

        def emit(kind_i, i, chunk, deps):
            nonlocal idx
            records.append((kind_i, t, i, chunk, deps))
            idx += 1
            return idx - 1

        def emit_ag(i):
            deps = tuple(d for d in (prev_e2a[i], prev_sha[i]) if d >= 0)
            a_id[i] = emit(_ATTN_I, i, 0, deps)
            gate_id[i] = emit(_GATE_I, i, 0, (a_id[i],))
            if rep:
                rep_id[i] = emit(_REP_I, i, 0, (gate_id[i],))

        def emit_shared(i):
            for k in range(n_seg):
                sha_last[i] = emit(_SHARED_I, i, k, (a_id[i],))

        if order == ORDER_ASAS:
            for i in range(r1):
                emit_ag(i)
                if has_shared:
                    emit_shared(i)
        else:                                  # AASS: all A's, then all S's
            for i in range(r1):
                emit_ag(i)
            if has_shared:
                for i in range(r1):
                    emit_shared(i)

        # chunk stream, FIFO by (i, j)
        for i in range(r1):
            gate_deps = [a_id[i], gate_id[i]]
            if shared_blocks_a2e and has_shared:
                gate_deps.append(sha_last[i])
            gd = tuple(gate_deps)
            for j in range(r2):
                a2e = emit(_A2E_I, i, j, gd)
                exp = emit(_EXP_I, i, j, (a2e,))
                prev_e2a[i] = emit(_E2A_I, i, j, (exp,))
            if has_shared:
                prev_sha[i] = sha_last[i]
            else:
                prev_sha[i] = rep_id[i] if rep_id[i] >= 0 else a_id[i]
        yield from records


# ---------------------------------------------------------------------------
# Costs + the generic resource-constrained list scheduler
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TaskCosts:
    """Per-kind durations (seconds). SHARED tasks are segments: each
    costs ``shared / graph.shared_segments`` so the whole shared expert
    still sums to ``t_s``."""

    attn: float
    shared: float
    exp: float
    comm: float
    gate: float = 0.0
    rep: float = 0.0

    @staticmethod
    def from_stage_times(st: StageTimes) -> "TaskCosts":
        return TaskCosts(attn=st.t_a, shared=st.t_s, exp=st.t_e,
                         comm=st.t_c, rep=getattr(st, "t_rep", 0.0))

    def per_kind(self, graph: TaskGraph) -> Tuple[float, ...]:
        """Durations indexed by KINDS order for ``graph``."""
        seg = self.shared / graph.shared_segments
        return (self.attn, seg, self.gate, self.comm, self.exp, self.comm,
                self.rep)


@dataclass(frozen=True)
class CostBreakdown:
    """Predicted seconds per hardware-primitive class for one plan
    execution -- the tags telemetry attributes measured residuals to."""

    gemm: float
    attn: float
    comm: float

    @property
    def total(self) -> float:
        return self.gemm + self.attn + self.comm

    def scaled(self, f: float) -> "CostBreakdown":
        return CostBreakdown(self.gemm * f, self.attn * f, self.comm * f)

    def normalized_to(self, total: float) -> "CostBreakdown":
        """Rescale so the classes sum to ``total`` (a plan's modeled
        makespan includes idle gaps the per-task busy sums don't)."""
        return self.scaled(total / self.total) if self.total > 0 else self

    def as_dict(self) -> Dict[str, float]:
        return {"gemm": self.gemm, "attn": self.attn, "comm": self.comm}


@dataclass
class ScheduleResult:
    """Exact per-task schedule of a graph under given costs.

    Per-kind busy sums and last completion times are accumulated inside
    the scheduling pass (every lane serves FIFO, so the last-emitted
    task of a kind carries that kind's max end) -- readers are O(1), no
    re-scan of the task list."""

    graph: TaskGraph
    starts: List[float]
    ends: List[float]
    busy: Dict[str, float]                 # per resource lane
    makespan: float
    busy_by_kind: Tuple[float, ...] = ()   # indexed by KINDS order
    last_by_kind: Tuple[float, ...] = ()   # indexed by KINDS order

    @property
    def intervals(self) -> Dict[str, List[Interval]]:
        """Per-resource (start, end) lists in service order -- the view
        ``non_overlapped_comm_time`` and the Gantt renderer consume."""
        out: Dict[str, List[Interval]] = {r: [] for r in RESOURCES}
        for t, s, e in zip(self.graph.tasks, self.starts, self.ends):
            out[t.resource].append((s, e))
        return out

    def spans(self) -> Tuple[Tuple[Task, float, float], ...]:
        """(task, start, end) triples in emission order -- the view the
        Chrome-trace exporter and the replay harness consume."""
        return tuple(zip(self.graph.tasks, self.starts, self.ends))

    def lane_idle(self) -> Dict[str, float]:
        """Idle seconds per resource lane within the makespan (lanes a
        graph never uses, e.g. links at r2=1 with zero comm cost, still
        report the full makespan as idle)."""
        return {r: self.makespan - self.busy.get(r, 0.0)
                for r in RESOURCES}

    def kind_busy(self) -> Dict[str, float]:
        """Summed busy seconds per task kind."""
        return dict(zip(KINDS, self.busy_by_kind))

    def breakdown(self) -> CostBreakdown:
        """Busy seconds per hardware-primitive class (gemm/attn/comm)."""
        cls: Dict[str, float] = {"gemm": 0.0, "attn": 0.0, "comm": 0.0}
        for k, v in self.kind_busy().items():
            cls[KIND_CLASS[k]] += v
        return CostBreakdown(**cls)

    def last_end(self, kind: str) -> float:
        """End of the last-scheduled task of ``kind`` (== that kind's
        max end: lanes are FIFO so ends increase in emission order)."""
        return self.last_by_kind[_KIND_IDX[kind]]

    def priority_hints(self) -> Tuple[int, ...]:
        """Per-task priority ranks derived from the scheduled
        ``starts``/``ends``: hint[i] = position of task i when all tasks
        are sorted by (start, end, emission index). This is the export
        the interleaved executor consumes (``ExecProgram.hints`` →
        ``TaskGraph.exec_interleaved``): emitting ops in hint order makes
        the executed program order *be* the schedule's start order —
        collective-matmul-style scheduling hints — instead of relying on
        XLA's async scheduler to rediscover the overlap. A schedule never
        starts a task before its deps end, so hint order is always a
        valid topological emission order."""
        n = len(self.starts)
        order = sorted(range(n),
                       key=lambda i: (self.starts[i], self.ends[i], i))
        hints = [0] * n
        for rank, idx in enumerate(order):
            hints[idx] = rank
        return tuple(hints)


def schedule(graph: TaskGraph, costs: TaskCosts) -> ScheduleResult:
    """Resource-constrained list scheduling over ANY TaskGraph: each
    resource serves its tasks in emission order; a task starts at
    max(resource free, deps done). Because the emission order fixes
    every resource's service order, a single forward pass is exact --
    this is the generic replacement for the hand-written simulator
    recurrences (and reproduces them to float precision)."""
    durs = costs.per_kind(graph)
    program = graph._program
    n = len(program)
    starts = [0.0] * n
    ends = [0.0] * n
    free = [0.0] * len(RESOURCES)
    busy = [0.0] * len(RESOURCES)
    kbusy = [0.0] * len(KINDS)
    klast = [0.0] * len(KINDS)
    idx = 0
    for r, k, deps in program:
        ready = 0.0
        for d in deps:
            e = ends[d]
            if e > ready:
                ready = e
        f = free[r]
        start = f if f > ready else ready
        dur = durs[k]
        end = start + dur
        starts[idx] = start
        ends[idx] = end
        free[r] = end
        busy[r] += dur
        kbusy[k] += dur
        klast[k] = end
        idx += 1
    makespan = max(ends) if ends else 0.0
    return ScheduleResult(graph=graph, starts=starts, ends=ends,
                          busy=dict(zip(RESOURCES, busy)),
                          makespan=makespan, busy_by_kind=tuple(kbusy),
                          last_by_kind=tuple(klast))


#: fixed shape-typical cost ratios used to order the default interleave
#: (only the relative magnitudes matter: comm chunks are comparable to
#: expert chunks, attention dominates a single shared segment). Plans
#: carrying a measured ``CostBreakdown`` derive sharper hints via
#: ``Plan.exec_program``.
_HINT_COSTS = TaskCosts(attn=4.0, shared=1.0, exp=2.0, comm=3.0,
                        gate=0.0, rep=0.5)


@dataclass(frozen=True)
class ExecProgram:
    """The executor-visible program: an exec ``TaskGraph`` plus the
    realized emission policy. This is what flows into
    ``dep.moe_apply_dep`` as a jit static argument (hashable; the graph
    hashes on its lowering scalars, the hints are a plain tuple).

    ``interleave``:
      * ``"off"``     — the historical single-stream walk: each
        micro-batch stream runs start-to-finish in program order
        (``exec_walk`` per stream, streams concatenated).
      * ``"streams"`` — ``exec_interleaved``: all r1 streams' ops
        emitted in scheduled start order, so micro-batch i+1's GATE
        group is issued before micro-batch i's E2A retires.

    Streams are realized as a capacity split, NOT a routing split: the
    router dispatch runs ONCE over the whole chunk (so token→expert
    assignment, capacity overflow, and drops are identical whatever the
    stream count), and each (stream i, chunk j) task covers capacity
    columns [(i·r2+j)·c, (i·r2+j+1)·c) of the dispatch buffers. The
    emitted values are therefore bit-identical across ``interleave``
    modes and stream counts — only the op order (and hence the achieved
    comm/compute overlap) changes.

    ``hints`` orders the ``"streams"`` emission
    (``ScheduleResult.priority_hints()``); ``None`` falls back to the
    structural default (``_HINT_COSTS``)."""

    graph: TaskGraph
    interleave: str = "off"
    hints: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.interleave not in ("off", "streams"):
            raise ValueError(
                f"interleave must be 'off' or 'streams', "
                f"got {self.interleave!r}")

    @property
    def streams(self) -> int:
        """Number of micro-batch streams the walk covers."""
        return self.graph.r1

    @property
    def capacity_multiple(self) -> int:
        """Alignment the executor's expert capacity must satisfy so
        every (stream, chunk) slice has equal width: streams·r2·m_e
        regardless of ``interleave`` — both modes slice the same
        (stream, chunk) grid, which is what makes them bit-identical."""
        return self.graph.r1 * self.graph.r2 * self.graph.m_e

    def walk(self) -> Tuple[Task, ...]:
        """The op-emission order the DEP executor realizes."""
        if self.interleave == "streams":
            return self.graph.exec_interleaved(self.hints)
        return tuple(t for s in self.graph.exec_streams() for t in s)


def stream_serial_deps(graph: TaskGraph) -> Dict[int, Tuple[int, ...]]:
    """The explicit cross-stream dependency edges that model the
    SEQUENTIAL executor: micro-batch stream i+1 starts only after stream
    i fully retires (the engine's chunked-prefill loop blocks on each
    chunk's output before issuing the next). Returns extra dep edges
    {first task of stream i: (last task of stream i-1 per lane, ...)}
    for i ≥ 1 — the edges ``obs.replay`` adds when replaying the
    sequential realization, and the complement of what the interleaved
    program removes."""
    extra: Dict[int, Tuple[int, ...]] = {}
    first_of: Dict[int, int] = {}
    last_per_lane: Dict[int, Dict[str, int]] = {}
    for idx, t in enumerate(graph.tasks):
        if t.mb not in first_of:
            first_of[t.mb] = idx
        last_per_lane.setdefault(t.mb, {})[t.resource] = idx
    for i in range(1, graph.r1):
        if i in first_of and (i - 1) in last_per_lane:
            extra[first_of[i]] = tuple(sorted(
                last_per_lane[i - 1].values()))
    return extra


def stream_major_order(graph: TaskGraph) -> Tuple[int, ...]:
    """Task indices reordered stream-major (all of micro-batch 0 in
    emission order, then micro-batch 1, ...) — the per-lane service
    order of the sequential realization. Paired with
    ``stream_serial_deps`` this is deadlock-free: every stream's tasks
    precede the next stream's in every lane's queue."""
    idx = sorted(range(len(graph.tasks)),
                 key=lambda i: (graph.tasks[i].mb, i))
    return tuple(idx)


def _fifo_ends(free0: float, ready, d: float):
    """End times of a FIFO lane serving equal-duration tasks: the
    recurrence e_k = max(e_{k-1}, r_k) + d unrolls to a running max of
    r_k - k*d (subtracting the k services already queued turns the
    serial dependency into a prefix maximum), which numpy scans in one
    ``maximum.accumulate`` instead of a Python loop."""
    import numpy as np
    r = np.asarray(ready, np.float64)
    k = np.arange(r.shape[0], dtype=np.float64)
    g = r - k * d
    if g.shape[0]:
        g[0] = max(g[0], free0)
    g = np.maximum.accumulate(g)
    return g + (k + 1.0) * d


def schedule_makespan(graph: TaskGraph, costs: TaskCosts) -> float:
    """Makespan of ``schedule(graph, costs)`` without materializing the
    per-task schedule.

    The generic list scheduler is exact but pays a ~3x Python-loop
    constant over the legacy hand-written recurrences,
    and the solver's simulate objective only consumes the makespan.
    Because every lane serves equal-duration tasks FIFO, each lane's
    completion times follow e_k = max(e_{k-1}, r_k) + d — a recurrence
    ``_fifo_ends`` evaluates as a vectorized prefix max. The only Python
    loop left is over layers. Agrees with ``schedule().makespan`` to
    float rounding (locked by test at 1e-9 relative).
    """
    import numpy as np
    durs = costs.per_kind(graph)
    attn_d, seg_d, gate_d = durs[_ATTN_I], durs[_SHARED_I], durs[_GATE_I]
    a2e_d, exp_d, e2a_d = durs[_A2E_I], durs[_EXP_I], durs[_E2A_I]
    rep_d = durs[_REP_I] if graph.hot_experts > 0 else 0.0
    has_rep = graph.hot_experts > 0
    r1, r2 = graph.r1, graph.r2
    n_seg = graph.shared_segments if graph.has_shared else 0
    asas = graph.order == ORDER_ASAS

    free_ag = free_a2e = free_eg = free_e2a = 0.0
    prev_e2a = np.zeros(r1)
    prev_sha = np.zeros(r1)
    ii = np.arange(r1, dtype=np.float64)
    for _ in range(graph.T):
        ready = np.maximum(prev_e2a, prev_sha)
        if asas:
            # per-mb AG block: ATTN, GATE, [REP], then n_seg shared segs
            block_d = attn_d + gate_d + rep_d + n_seg * seg_d
            block_end = _fifo_ends(free_ag, ready, block_d)
            attn_end = block_end - block_d + attn_d
            gate_end = attn_end + gate_d
            rep_end = gate_end + rep_d
            sha_end = rep_end + n_seg * seg_d
            free_ag = float(block_end[-1])
        else:
            # AASS: all (ATTN, GATE, [REP]) blocks, then all shared tasks
            block_d = attn_d + gate_d + rep_d
            block_end = _fifo_ends(free_ag, ready, block_d)
            attn_end = block_end - block_d + attn_d
            gate_end = attn_end + gate_d
            rep_end = block_end
            free_ag = float(block_end[-1])
            if n_seg:
                # shared(i) deps only attn(i), which ends before the last
                # gate — the lane never waits, so the ends are a cumsum
                sha_end = free_ag + (ii + 1.0) * seg_d
                free_ag = float(sha_end[-1])
            else:
                sha_end = attn_end
        gd = gate_end
        if graph.shared_blocks_a2e and graph.has_shared:
            gd = np.maximum(gd, sha_end)
        a2e_end = _fifo_ends(free_a2e, np.repeat(gd, r2), a2e_d)
        exp_end = _fifo_ends(free_eg, a2e_end, exp_d)
        e2a_end = _fifo_ends(free_e2a, exp_end, e2a_d)
        free_a2e = float(a2e_end[-1])
        free_eg = float(exp_end[-1])
        free_e2a = float(e2a_end[-1])
        prev_e2a = e2a_end.reshape(r1, r2)[:, -1]
        if graph.has_shared:
            prev_sha = sha_end
        else:
            prev_sha = rep_end if has_rep else attn_end
    return max(free_ag, free_a2e, free_eg, free_e2a)


# ---------------------------------------------------------------------------
# ASCII Gantt rendering (benchmarks/plan_trace.py)
# ---------------------------------------------------------------------------

_GANTT_GLYPH = {ATTN: "A", SHARED: "S", GATE: "g", A2E: ">", EXP: "E",
                E2A: "<", REP: "R"}


def ascii_gantt(res: ScheduleResult, width: int = 80) -> str:
    """Render a scheduled graph as one text row per resource lane; each
    column is makespan/width seconds, marked with the glyph of the task
    occupying it ('.' = idle, '*' = multiple kinds in one column)."""
    if res.makespan <= 0.0:
        return "\n".join(f"{r:>4} |" for r in RESOURCES)
    scale = width / res.makespan
    rows = []
    for r in RESOURCES:
        cells = ["."] * width
        for t, s, e in zip(res.graph.tasks, res.starts, res.ends):
            if t.resource != r or e <= s:
                continue
            lo = min(int(s * scale), width - 1)
            hi = min(max(int(e * scale), lo + 1), width)
            g = _GANTT_GLYPH[t.kind]
            for c in range(lo, hi):
                cells[c] = g if cells[c] in (".", g) else "*"
        rows.append(f"{r:>4} |{''.join(cells)}|")
    rows.append(f"     0{'-' * (width - 10)}{res.makespan * 1e3:8.3f}ms")
    return "\n".join(rows)
