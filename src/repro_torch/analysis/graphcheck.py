"""A copy of ``repro.analysis.graphcheck``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

Static verifier over ``core/taskgraph.py`` artifacts.

The task-graph IR carries the repo's scheduling correctness: the lowered
graph must be acyclic with sound deps, its exact FIFO-lane schedule must
be race-free (no two tasks overlap on one resource lane, no task starts
before a dependency ends), every realization the executor can take must
be deadlock-free, the chunk stream must conserve capacity (each
(mb, chunk) slice produced exactly once, ``capacity_multiple ==
r1*r2*m_e``), and any priority-hint vector must be a dep-consistent
permutation. No runtime test can cover every (policy, r1, r2, m_a, m_e,
order) combination; this module proves the properties on the lowered
structure directly — and ``sweep`` walks the full benchmark shape space
(all four policies x Table-5/7 shapes x r1 in {1,2,4} x ASAS/AASS).

Deadlock detection is wait-for-graph cycle detection, NOT replay: a
realization is a per-lane FIFO service order plus optional extra dep
edges (``stream_serial_deps`` models the sequential executor). A task
waits for its deps and for its lane predecessor; a cycle in that
relation is a schedule that can never complete. Emission order is
deadlock-free even with the cross-stream serial edges (each stream's
tasks precede the next stream's on every lane it shares), so the
canonical NEGATIVE case is a service order that queues a task ahead of
its own dependency on a shared lane — e.g. GATE before its ATTN on the
AG lane, an immediate two-cycle (GATE dep-waits ATTN, ATTN lane-waits
GATE) — which the detector must report with the witness cycle.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.report import Violation
from repro_torch.core.analytic import ORDER_AASS, ORDER_ASAS
from repro_torch.core.taskgraph import (A2E, ATTN, E2A, EXP, GATE, KIND_RESOURCE,
                                  KINDS, REP, RESOURCES, SHARED, _HINT_COSTS,
                                  ExecProgram, LoweringSpec, ScheduleResult,
                                  TaskCosts, TaskGraph, lower, schedule,
                                  stream_major_order, stream_serial_deps)

PASS = "graphcheck"

#: chunk-stream kinds that must each cover the full (mb, chunk) grid
_CHUNK_KINDS = (A2E, EXP, E2A)


def _where(graph: TaskGraph) -> str:
    return (f"graph(T={graph.T}, r1={graph.r1}, r2={graph.r2}, "
            f"order={graph.order}, m_e={graph.m_e}, "
            f"shared={graph.has_shared}, "
            f"blocks_a2e={graph.shared_blocks_a2e}, "
            f"hot={graph.hot_experts})")


def _desc(graph: TaskGraph, idx: int) -> str:
    t = graph.tasks[idx]
    return (f"{t.kind}(layer={t.layer}, mb={t.mb}, chunk={t.chunk}, "
            f"emission={idx})")


# ---------------------------------------------------------------------------
# structure: dep soundness + field ranges
# ---------------------------------------------------------------------------


def check_structure(graph: TaskGraph) -> List[Violation]:
    """Deps must point to earlier emissions (acyclicity by construction),
    kinds/resources must be known, and (layer, mb, chunk) must lie in the
    lowering's ranges."""
    out: List[Violation] = []
    w = _where(graph)
    for i, t in enumerate(graph.tasks):
        if t.kind not in KINDS:
            out.append(Violation(PASS, "unknown-kind", w,
                                 f"task {i} has unknown kind {t.kind!r}"))
            continue
        if KIND_RESOURCE[t.kind] not in RESOURCES:
            out.append(Violation(PASS, "unknown-resource", w,
                                 f"task {i} ({t.kind}) maps to unknown "
                                 f"resource {KIND_RESOURCE[t.kind]!r}"))
        for d in t.deps:
            if not 0 <= d < i:
                out.append(Violation(
                    PASS, "dep-not-earlier", w,
                    f"{_desc(graph, i)} depends on index {d}, which is "
                    f"not an earlier emission — the tuple is no longer "
                    f"topologically ordered"))
        if not 0 <= t.layer < graph.T:
            out.append(Violation(PASS, "layer-range", w,
                                 f"{_desc(graph, i)} layer out of "
                                 f"[0, {graph.T})"))
        if not 0 <= t.mb < graph.r1:
            out.append(Violation(PASS, "mb-range", w,
                                 f"{_desc(graph, i)} mb out of "
                                 f"[0, {graph.r1})"))
        if t.kind in _CHUNK_KINDS:
            hi = graph.r2
        elif t.kind == SHARED:
            hi = graph.shared_segments
        else:
            hi = 1
        if not 0 <= t.chunk < hi:
            out.append(Violation(PASS, "chunk-range", w,
                                 f"{_desc(graph, i)} chunk out of "
                                 f"[0, {hi})"))
    return out


# ---------------------------------------------------------------------------
# race detector over a ScheduleResult
# ---------------------------------------------------------------------------


def check_schedule_result(res: ScheduleResult) -> List[Violation]:
    """Lane races and dep-order slips in an exact schedule: on every
    resource lane the (start, end) intervals must be non-overlapping in
    service order, and every task must start at/after the end of each of
    its deps (within float epsilon of the makespan scale)."""
    out: List[Violation] = []
    graph = res.graph
    w = _where(graph)
    eps = 1e-9 * max(res.makespan, 1.0)
    prev_end: Dict[str, float] = {}
    prev_idx: Dict[str, int] = {}
    for i, t in enumerate(graph.tasks):
        s, e = res.starts[i], res.ends[i]
        if e < s - eps:
            out.append(Violation(PASS, "negative-duration", w,
                                 f"{_desc(graph, i)} ends before it "
                                 f"starts ({s:.3e} -> {e:.3e})"))
        lane = t.resource
        if lane in prev_end and s < prev_end[lane] - eps:
            out.append(Violation(
                PASS, "lane-race", w,
                f"lane {lane}: {_desc(graph, i)} starts at {s:.3e} while "
                f"{_desc(graph, prev_idx[lane])} still occupies the lane "
                f"until {prev_end[lane]:.3e}"))
        prev_end[lane] = e
        prev_idx[lane] = i
        for d in t.deps:
            if s < res.ends[d] - eps:
                out.append(Violation(
                    PASS, "dep-order", w,
                    f"{_desc(graph, i)} starts at {s:.3e} before its "
                    f"dependency {_desc(graph, d)} ends at "
                    f"{res.ends[d]:.3e}"))
    return out


# ---------------------------------------------------------------------------
# capacity conservation
# ---------------------------------------------------------------------------


def check_capacity(graph: TaskGraph) -> List[Violation]:
    """Every (mb, chunk) slice of the chunk stream is produced exactly
    once per layer for each of A2E/EXP/E2A; ATTN/GATE (and REP when hot
    experts are placed) appear once per (layer, mb); SHARED covers each
    emission boundary once per (layer, mb)."""
    out: List[Violation] = []
    w = _where(graph)
    grid = {(i, j) for i in range(graph.r1) for j in range(graph.r2)}
    by_layer_kind: Dict[Tuple[int, str], Counter] = defaultdict(Counter)
    for t in graph.tasks:
        by_layer_kind[(t.layer, t.kind)][(t.mb, t.chunk)] += 1

    def expect(layer: int, kind: str, want: Dict) -> None:
        got = by_layer_kind.get((layer, kind), Counter())
        if got == want:
            return
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        dup = sorted(k for k, n in got.items() if n > want.get(k, 0) and
                     k in want)
        parts = []
        if missing:
            parts.append(f"missing {missing[:4]}")
        if extra:
            parts.append(f"unexpected {extra[:4]}")
        if dup:
            parts.append(f"duplicated {dup[:4]}")
        out.append(Violation(
            PASS, "capacity-conservation", w,
            f"layer {layer} {kind}: (mb, chunk) coverage broken — "
            + ", ".join(parts)))

    for layer in range(graph.T):
        for kind in _CHUNK_KINDS:
            expect(layer, kind, Counter({k: 1 for k in grid}))
        per_mb = Counter({(i, 0): 1 for i in range(graph.r1)})
        expect(layer, ATTN, per_mb)
        expect(layer, GATE, per_mb)
        expect(layer, REP,
               per_mb if graph.hot_experts > 0 else Counter())
        if graph.has_shared:
            expect(layer, SHARED,
                   Counter({(i, k): 1 for i in range(graph.r1)
                            for k in range(graph.shared_segments)}))
        else:
            expect(layer, SHARED, Counter())
    return out


def check_capacity_multiple(program: ExecProgram) -> List[Violation]:
    """``capacity_multiple`` must equal r1*r2*m_e — the alignment that
    makes every (stream, chunk) slice of the dispatch buffers equal
    width (and hence the interleave modes bit-identical)."""
    g = program.graph
    want = g.r1 * g.r2 * g.m_e
    if program.capacity_multiple == want:
        return []
    return [Violation(
        PASS, "capacity-multiple", _where(g),
        f"capacity_multiple {program.capacity_multiple} != "
        f"r1*r2*m_e = {g.r1}*{g.r2}*{g.m_e} = {want}")]


# ---------------------------------------------------------------------------
# deadlock detector: wait-for-graph cycle detection over a realization
# ---------------------------------------------------------------------------


def find_deadlock(graph: TaskGraph,
                  service_order: Optional[Sequence[int]] = None,
                  extra_deps: Optional[Dict[int, Tuple[int, ...]]] = None,
                  ignore_kinds: Iterable[str] = ()
                  ) -> Optional[List[int]]:
    """Cycle in the wait-for graph of one realization, or None.

    A realization is a per-lane FIFO service order (default: emission
    order) plus optional extra dep edges (``stream_serial_deps`` for the
    sequential executor). Task i waits for (a) every dep, (b) the task
    queued immediately before it on its lane. ``ignore_kinds`` treats
    those tasks as already complete (the exec walk runs ATTN outside the
    MoE layer). Returns one witness cycle as task indices."""
    n = len(graph.tasks)
    ignore = set(ignore_kinds)
    live = [i for i in range(n) if graph.tasks[i].kind not in ignore]
    live_set = set(live)
    order = [i for i in (service_order if service_order is not None
                         else range(n)) if i in live_set]
    if set(order) != live_set:
        # a service order that skips or repeats tasks is itself a
        # deadlock of the missing tasks; report them as a "cycle"
        missing = sorted(live_set - set(order))
        if missing:
            return missing[:8]
        order = list(dict.fromkeys(order))
    waits: Dict[int, set] = {i: set() for i in live}
    last: Dict[str, int] = {}
    for i in order:
        lane = graph.tasks[i].resource
        if lane in last:
            waits[i].add(last[lane])
        last[lane] = i
    for i in live:
        waits[i].update(d for d in graph.tasks[i].deps if d in live_set)
    if extra_deps:
        for i, ds in extra_deps.items():
            if i in live_set:
                waits[i].update(d for d in ds if d in live_set)
    # Kahn: peel tasks whose waits are all satisfied
    dependents: Dict[int, List[int]] = defaultdict(list)
    indeg: Dict[int, int] = {}
    for i, ws in waits.items():
        indeg[i] = len(ws)
        for d in ws:
            dependents[d].append(i)
    ready = [i for i, k in indeg.items() if k == 0]
    done = 0
    while ready:
        cur = ready.pop()
        done += 1
        for j in dependents[cur]:
            indeg[j] -= 1
            if indeg[j] == 0:
                ready.append(j)
    if done == len(live):
        return None
    # extract one witness cycle from the stuck subgraph
    stuck = {i for i, k in indeg.items() if k > 0}
    node = min(stuck)
    path, seen_at = [], {}
    while node not in seen_at:
        seen_at[node] = len(path)
        path.append(node)
        node = min(w for w in waits[node] if w in stuck)
    return path[seen_at[node]:]


def _deadlock_violation(graph: TaskGraph, cycle: List[int],
                        realization: str) -> Violation:
    chain = " -> ".join(_desc(graph, i) for i in cycle[:6])
    if len(cycle) > 6:
        chain += f" -> ... ({len(cycle)} tasks)"
    return Violation(
        PASS, "deadlock", _where(graph),
        f"{realization} realization deadlocks: wait-for cycle "
        f"{chain} -> (back to start)")


def check_deadlock(graph: TaskGraph) -> List[Violation]:
    """The realizations the system actually executes must complete:
    emission-order service (the scheduler's and the interleaved walk's
    default) and the sequential executor (stream-major service order +
    cross-stream serial deps)."""
    out: List[Violation] = []
    cycle = find_deadlock(graph)
    if cycle:
        out.append(_deadlock_violation(graph, cycle, "emission-order"))
    cycle = find_deadlock(graph,
                          service_order=stream_major_order(graph),
                          extra_deps=stream_serial_deps(graph))
    if cycle:
        out.append(_deadlock_violation(graph, cycle,
                                       "sequential (stream-major)"))
    return out


# ---------------------------------------------------------------------------
# hint-vector validity
# ---------------------------------------------------------------------------


def check_hints(program: ExecProgram) -> List[Violation]:
    """An interleaved program's hint vector must be a permutation of the
    emission indices whose sorted order respects every dep (a tampered or
    stale vector fails here at plan time rather than mid-trace)."""
    out: List[Violation] = []
    graph = program.graph
    w = _where(graph)
    hints = program.hints
    if program.interleave != "streams":
        return out
    if hints is not None:
        n = len(graph.tasks)
        if len(hints) != n:
            out.append(Violation(
                PASS, "hint-length", w,
                f"hint vector has {len(hints)} entries for {n} tasks"))
            return out
        if any(not isinstance(h, int) for h in hints):
            out.append(Violation(PASS, "hint-type", w,
                                 "hint vector has non-int entries"))
            return out
        if sorted(hints) != list(range(n)):
            out.append(Violation(
                PASS, "hint-not-permutation", w,
                f"hints are not a permutation of 0..{n - 1} "
                f"(priority ranks from ScheduleResult.priority_hints)"))
    try:
        program.graph.exec_interleaved(hints)
    except ValueError as e:
        out.append(Violation(PASS, "hint-dep-order", w, str(e)))
    return out


# ---------------------------------------------------------------------------
# composite checks
# ---------------------------------------------------------------------------


def check_graph(graph: TaskGraph,
                costs: Optional[TaskCosts] = None) -> List[Violation]:
    """All structural properties of one lowered graph: dep soundness,
    capacity conservation, deadlock freedom of the executed realizations,
    and schedule race/dep-order under ``costs`` (structural default when
    None)."""
    out = check_structure(graph)
    if out:
        return out          # downstream checks assume sound indices
    out += check_capacity(graph)
    out += check_deadlock(graph)
    out += check_schedule_result(schedule(graph, costs or _HINT_COSTS))
    return out


def check_exec_program(program: ExecProgram) -> List[Violation]:
    """Everything the DEP executor assumes about a program it is handed:
    graph soundness, capacity alignment, hint validity, full walk
    coverage (each non-ATTN layer-0 task emitted exactly once), and
    deadlock freedom of the emitted op order."""
    graph = program.graph
    out = check_structure(graph)
    if out:
        return out
    out += check_capacity(graph)
    out += check_capacity_multiple(program)
    out += check_deadlock(graph)
    out += check_hints(program)
    if any(v.code.startswith("hint") for v in out):
        return out          # the walk below would raise on bad hints
    w = _where(graph)
    walk = program.walk()
    want = Counter((t.kind, t.mb, t.chunk) for t in graph.tasks
                   if t.layer == 0 and t.kind != ATTN)
    got = Counter((t.kind, t.mb, t.chunk) for t in walk)
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        out.append(Violation(
            PASS, "walk-coverage", w,
            f"walk ({program.interleave}) does not cover the layer slice "
            f"exactly once: missing {missing[:4]}, unexpected "
            f"{extra[:4]}"))
        return out
    # the emitted op order is a realization: lanes serve in walk order
    index_of = {t: i for i, t in enumerate(graph.tasks)}
    cycle = find_deadlock(graph,
                          service_order=[index_of[t] for t in walk],
                          ignore_kinds=(ATTN,))
    if cycle:
        out.append(_deadlock_violation(
            graph, cycle, f"walk ({program.interleave})"))
    return out


# ---------------------------------------------------------------------------
# the exhaustive sweep (CLI / CI gate)
# ---------------------------------------------------------------------------

#: Table-5 shape space: both backbones x paper sequence lengths at the
#: paper depths; Table-7 adds the overlap study's deepseek shapes with
#: the naive/PPPipe lowering semantics (shared_blocks_a2e).
_BACKBONES = {"deepseek": "deepseek-v2-lite", "qwen3": "qwen3-moe"}
_DEPTHS = {"deepseek": 8, "qwen3": 24}
_TABLE5_SEQS = (1024, 2048, 4096, 8192)
_TABLE7_SEQS = (1024, 2048, 4096)
_R1_SWEEP = (1, 2, 4)
_ORDERS = (ORDER_ASAS, ORDER_AASS)


def _testbeds():
    from repro_torch.core.perf_model import PAPER_A6000, TPU_V5E
    return {"A(a6000)": (PAPER_A6000, 3, 5, 4),
            "v5e": (TPU_V5E, 3, 5, 8)}


def _policies(planner, seq_len):
    from repro_torch.sched.policy import POLICIES, make_policy
    return [(name, make_policy(name, planner, static_seq_len=seq_len))
            for name in POLICIES]


def sweep(fast: bool = False, log=None) -> Tuple[List[Violation], int]:
    """Verify every lowering the benchmark tables exercise: all four
    policies x Table-5/7 shapes x r1 in {1,2,4} x both dispatch orders,
    checking the full T-layer graph (both shared_blocks_a2e semantics)
    under the shape's modeled stage costs plus both interleave modes of
    the exec program. Returns (violations, graphs_checked).

    ``fast`` restricts to one testbed, two sequence lengths and
    r1 in {1, 4} — the same properties on a representative slice (test
    and benchmark-harness budget)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import DepClusterConfig
    from repro_torch.core.analytic import StageTimes
    from repro_torch.core.planner import FinDEPPlanner, PlannerConfig

    violations: List[Violation] = []
    combos = 0
    checked_graphs: set = set()
    checked_sched: set = set()
    checked_progs: set = set()
    testbeds = _testbeds()
    if fast:
        testbeds = {"A(a6000)": testbeds["A(a6000)"]}
    r1_sweep = (1, 4) if fast else _R1_SWEEP

    for tb_name, (hw, ag, eg, cap) in testbeds.items():
        cluster = DepClusterConfig(num_devices=ag + eg, ag=ag, eg=eg)
        for backbone, cfg_name in _BACKBONES.items():
            cfg = get_config(cfg_name)
            T = _DEPTHS[backbone]
            planner = FinDEPPlanner(
                cfg, cluster, hw,
                PlannerConfig(mem_cap_samples=cap, r2_cap=32, T_override=T))
            seqs = set(_TABLE5_SEQS)
            if backbone == "deepseek":
                seqs |= set(_TABLE7_SEQS)
            if fast:
                seqs = {1024, 4096}
            for S in sorted(seqs):
                models = planner.stage_models(S)
                for pol_name, policy in _policies(planner, S):
                    plan = policy.resolve("prefill", S)
                    st = StageTimes.from_models(models, plan.m_a, plan.m_e)
                    costs = TaskCosts.from_stage_times(st)
                    where = f"{tb_name}/{backbone}/S={S}/{pol_name}"
                    for r1 in r1_sweep:
                        for order in _ORDERS:
                            v = dataclasses.replace(plan, r1=r1,
                                                    order=order)
                            for blocks in (False, True):
                                graph = planner.lower(
                                    v, shared_blocks_a2e=blocks)
                                combos += 1
                                if graph not in checked_graphs:
                                    checked_graphs.add(graph)
                                    violations += check_capacity(graph)
                                    violations += check_deadlock(graph)
                                    violations += check_structure(graph)
                                key = (graph, costs)
                                if key not in checked_sched:
                                    checked_sched.add(key)
                                    violations += check_schedule_result(
                                        schedule(graph, costs))
                            for mode in ("streams", "off"):
                                prog = v.exec_program(interleave=mode)
                                if prog in checked_progs:
                                    continue
                                checked_progs.add(prog)
                                violations += check_exec_program(prog)
                    if log is not None:
                        log(f"{where}: {combos} graphs checked, "
                            f"{len(violations)} violations")
    return violations, combos


def run(fast: bool = False, log=None) -> Tuple[List[Violation], Dict]:
    """CLI entry: the sweep plus its coverage metadata."""
    violations, combos = sweep(fast=fast, log=log)
    return violations, {"graphs_checked": combos, "fast": fast}
