"""One run of one cell: set-up, warm-up, the measured window, an optional
traced span, the metrics, and the check of the served tokens.

Set-up (``setup_s``) runs from the start of the process to the start of
the window: the imports, the weights drawn on the device from the seed,
the engine (FinDEP through the engine's plan cache, solved on the frozen
profile in ``profiles/``, over a DEP group of one rank), the kernel
library (built into the checkout's ``.kernel-build/`` by the first run
and loaded by every later one) and the warm-up: the cell's own closed
loop until a stretch of steps captures no decode graph and solves no
prefill plan (``warmup`` in the mix; ``warm_marks``). The window then
steps the engine in the same closed loop for ``--seconds``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level module names the process may not hold once the window has
#: closed (the JAX reference package and JAX itself)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: seconds of the traced span that follows the window in a --trace 1 run
TRACE_SECONDS = 3.0


@dataclass
class ReqRec:
    """A request as its client sent it, and when each token came."""
    spec: Any
    client: int
    req: Any
    sent: float
    token_times: List[float] = field(default_factory=list)
    finished: bool = False


@dataclass
class StepRec:
    """One engine step: its bounds on the host clock, the tokens it
    served as (request index, positions that token's query attended),
    and the requests it prefilled."""
    t0: float
    t1: float
    tokens: List[Tuple[int, int]]
    admitted: List[int]


class Loop:
    """The closed loop: every client has one request in flight, and sends
    the next as soon as the engine finishes the last."""

    TERMINAL = ("finished", "rejected", "length_capped")

    def __init__(self, engine, traffic, clients: int):
        from repro_torch.runtime.request import Request
        self._request = Request
        self.engine = engine
        self.traffic = traffic
        self.recs: Dict[int, ReqRec] = {}
        self.active: List[ReqRec] = []
        self.next_index = 0
        for c in range(clients):
            self._send(c)

    def _send(self, client: int) -> None:
        spec = self.traffic.request(self.next_index)
        self.next_index += 1
        now = time.perf_counter()
        req = self._request(prompt=spec.prompt,
                            max_new_tokens=spec.max_new_tokens,
                            temperature=spec.temperature, arrival_t=now)
        rec = ReqRec(spec, client, req, now)
        self.recs[spec.index] = rec
        self.active.append(rec)
        self.engine.submit(req)

    def step(self) -> StepRec:
        had = [(len(r.req.output), r.req.admit_t is not None)
               for r in self.active]
        t0 = time.perf_counter()
        self.engine.step()
        t1 = time.perf_counter()
        rec = StepRec(t0, t1, [], [])
        still, done = [], []
        for r, (n, admitted) in zip(self.active, had):
            if not admitted and r.req.admit_t is not None:
                rec.admitted.append(r.spec.index)
            if len(r.req.output) > n:
                r.token_times.append(t1)
                rec.tokens.append((r.spec.index, len(r.spec.prompt)
                                   + len(r.req.output) - 1))
            if r.req.state.value in self.TERMINAL:
                r.finished = r.req.state.value == "finished"
                done.append(r)
            else:
                still.append(r)
        self.active = still
        for r in done:
            self._send(r.client)
        return rec


def engine_counters(engine) -> Dict[str, Any]:
    s = engine.stats
    out = dict(prefill_s=s.prefill_s, decode_s=s.decode_s, steps=s.steps,
               prefill_calls=s.prefill_calls,
               prefill_tokens=s.prefill_tokens,
               decode_tokens=s.decode_tokens,
               graph_captures=s.graph_captures, graph_s=s.graph_s,
               programs=len(s.programs), plan_misses=0, plan_solve_s=0.0)
    if engine.plan_cache is not None:
        out["plan_misses"] = engine.plan_cache.stats.misses
        out["plan_solve_s"] = engine.plan_cache.stats.solve_time_total
    return out


@dataclass
class Window:
    """What the metric readers read: the cell, its configuration and mix,
    the window's bounds and steps, every request, the engine's counters
    at both ends, the DEP programs the window ran, and the traced span
    (None without --trace 1)."""
    cell: Dict[str, Any]
    served: Dict[str, Any]
    mix: Dict[str, Any]
    setup_s: float
    t0: float
    t1: float
    steps: List[StepRec]
    recs: Dict[int, ReqRec]
    before: Dict[str, Any]
    after: Dict[str, Any]
    programs: List[Tuple[str, Any]]
    trace: Any = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def delta(self, name: str):
        return self.after[name] - self.before[name]


# ---------------------------------------------------------------------------
# files found by name
# ---------------------------------------------------------------------------

def load_benchmark() -> Dict[str, Any]:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(bench: Dict[str, Any], cell_name: str):
    """(cell, config entry, served section, mix) of a cell."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[cell_name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    from bench.traffic import load_mix
    served = json.loads((ROOT / config["file"]).read_text())["served"]
    return cell, config, served, load_mix(BENCH / "mixes"
                                          / f"{cell['traffic']}.json")


def cell_metrics(bench: Dict[str, Any], cell_name: str,
                 trace: bool) -> List[Dict[str, Any]]:
    """The metrics a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones; a metric with ``workloads`` only in
    those cells."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else the
    reader of its base name (the part before the first dot), whose
    suffix names the mix it is split by."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"bench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader for metric {name!r} under {BENCH / 'metrics'}")


def limits(cell_name: str) -> Dict[str, Any]:
    path = BENCH / "limits" / f"{cell_name}.json"
    return json.loads(path.read_text()) if path.is_file() else {}


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

def make_groups(device):
    """The DEP expert group of one rank: NCCL on the card over a
    ``file://`` store in a fresh directory under the run's TMPDIR, gloo
    on the CPU. Returns (groups, the store's directory or None when a
    process group already existed)."""
    import torch.distributed as dist
    from repro_torch.core.dep import DepGroups
    if dist.is_initialized():
        return DepGroups.build(1, dist.get_world_size()), None
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = tempfile.mkdtemp(prefix="bench-store-")
    return DepGroups.from_file_store(store, 0, 1, 1, backend), store


def load_profile(served: Dict[str, Any]):
    """The frozen profile the planner solves on: ``profiles/<name>.json``,
    else a profile the program registers under that name."""
    from repro_torch.core.perf_model import get_profile
    from repro_torch.profiling.store import ProfileStore
    store = ProfileStore(str(BENCH / "profiles"))
    try:
        return store.load_profile(served["profile"])
    except KeyError:
        return get_profile(served["profile"])


def build_engine(cfg, served, mix, params, device, seed: int, groups):
    """The engine under test: FinDEP through the engine's plan cache on
    the frozen profile, the DEP walker over ``groups``, the mix's slots,
    context and prefill token budget, the served dtype."""
    from repro_torch.configs.base import DepClusterConfig
    from repro_torch.core.planner import FinDEPPlanner, PlannerConfig
    from repro_torch.runtime.engine import ServingEngine
    from repro_torch.sched.policy import FinDEPPolicy
    from bench.model import DTYPES
    pl = served["planner"]
    planner = FinDEPPlanner(
        cfg, DepClusterConfig(pl["num_devices"], pl["ag"], pl["eg"]),
        load_profile(served), PlannerConfig(
            mem_cap_samples=pl["mem_cap_samples"]))
    return ServingEngine(
        cfg, params=params, num_slots=mix["slots"],
        max_context=mix["max_context"], token_budget=mix["token_budget"],
        dtype=DTYPES[served["dtype"]], device=device, seed=seed,
        plan_policy=FinDEPPolicy(planner), ep_group=groups)


def warm_marks(engine) -> Tuple[int, int]:
    """What the warm-up waits on: the decode graphs captured and the
    prefill plans solved. Both key spaces are finite (the decode
    programs; the prefill shape buckets). Decode plans are keyed by the
    live slots' occupancy histogram, a space 32 churning slots never
    exhaust: their solves are part of serving, and the window counts
    them (``plan_misses``) and their seconds (``plan_solve_s``)."""
    prefill = 0
    if engine.plan_cache is not None:
        prefill = sum(1 for key in engine.plan_cache.entries()
                      if key[0] == "prefill")
    return engine.stats.graph_captures, prefill


def warm_up(loop: Loop, engine, spec: Dict[str, int]) -> Dict[str, Any]:
    """Step the closed loop until ``quiet_steps`` steps in a row capture
    no decode graph and solve no prefill plan (after ``min_steps``, at
    most ``max_steps``). Returns the steps taken, whether the quiet
    stretch was reached, and the step of the last capture or solve."""
    last, quiet, n, last_new = warm_marks(engine), 0, 0, 0
    reached = False
    while n < spec["max_steps"]:
        loop.step()
        n += 1
        now = warm_marks(engine)
        if now == last:
            quiet += 1
        else:
            quiet, last_new = 0, n
        last = now
        if n >= spec["min_steps"] and quiet >= spec["quiet_steps"]:
            reached = True
            break
    return {"warmup_steps": n, "warmup_quiet": reached,
            "warmup_last_new_step": last_new}


def forbidden(names) -> List[str]:
    """The top-level names among module ``names`` that are in
    ``FORBIDDEN``, each compared whole (``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def forbidden_modules() -> List[str]:
    return forbidden(list(sys.modules))


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """A finished run: the window, the device facts, and what the check
    compared."""
    window: Window
    device: Dict[str, Any]
    gap: Optional[Dict[str, float]]
    checked_tokens: int
    checked_requests: int
    engine_info: Dict[str, Any]


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, bench: Optional[Dict] = None,
             served: Optional[Dict] = None, mix: Optional[Dict] = None,
             control: bool = False,
             window_steps: Optional[int] = None
             ) -> Tuple[Run, Dict[str, Any]]:
    """Set up, warm up, measure and check one cell. ``device`` None means
    the card; ``served`` and ``mix`` replace the cell's files, and
    ``window_steps`` makes the window that many steps instead of
    ``seconds`` (the CPU tests' small sizes, whose work must not depend
    on the host's speed). With ``control`` the check also runs the fp8
    control. Returns (the run, the check's readings)."""
    import torch
    from bench import check, model, traffic as traffic_lib
    from repro_torch import resolve_device
    bench = bench if bench is not None else load_benchmark()
    cell, _, served0, mix0 = cell_files(bench, cell_name)
    served = served if served is not None else served0
    mix = mix if mix is not None else mix0
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = model.model_config(served)
    marks = {"imports": time.perf_counter() - t_start}
    params = model.draw_params(served, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    marks["weights"] = time.perf_counter() - t_start
    groups, store = make_groups(dev)
    engine = build_engine(cfg, served, mix, params, dev, seed, groups)
    marks["engine"] = time.perf_counter() - t_start
    loop = Loop(engine, traffic_lib.Traffic(mix, seed, cfg.vocab_size),
                mix["clients"])
    warm = warm_up(loop, engine, mix["warmup"])
    if not warm["warmup_quiet"]:
        print(f"warm-up: no quiet stretch of {mix['warmup']['quiet_steps']} "
              f"steps in {warm['warmup_steps']}; the last capture or "
              f"prefill solve came at step {warm['warmup_last_new_step']}",
              file=sys.stderr)
    if cuda:
        torch.cuda.synchronize(dev)
    before = engine_counters(engine)
    n_prog = len(engine.stats.programs)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps = []
    while (len(steps) < window_steps if window_steps is not None
           else time.perf_counter() - t0 < seconds):
        steps.append(loop.step())
    t1 = steps[-1].t1 if steps else time.perf_counter()
    after = engine_counters(engine)
    programs = list(engine.stats.programs[n_prog:])
    window = Window(cell, served, mix, setup_s, t0, t1, steps, loop.recs,
                    before, after, programs)
    if trace:
        from bench import trace as trace_lib
        window.trace = trace_lib.traced_span(loop, TRACE_SECONDS, dev)
        marks["trace"] = time.perf_counter() - t_start
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if cuda else 0)}
    if trace and window.trace is not None:
        device_info["busy_s"] = window.trace.busy_s
        device_info["window_s"] = window.trace.window_s
    marks["warm_up"] = t0 - t_start
    marks["window"] = t1 - t_start
    info = dict(warm, window_steps=len(steps),
                requests_sent=loop.next_index,
                window_plan_misses=after["plan_misses"]
                - before["plan_misses"],
                window_plan_solve_s=after["plan_solve_s"]
                - before["plan_solve_s"],
                window_graph_captures=after["graph_captures"]
                - before["graph_captures"],
                window_graph_s=after["graph_s"] - before["graph_s"],
                marks_s=marks)
    # the program's state goes before the reference runs
    engine.close()
    del engine, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if store is not None:
        import shutil
        import torch.distributed as dist
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    marks["freed"] = time.perf_counter() - t_start
    chosen = check.sample(list(window.recs.values()), t0, t1, seed,
                          mix["check"]["served_tokens"])
    ref_cfg = model.reference_config(served)
    readings: Dict[str, Any] = {}
    gap = None
    if chosen:
        if control:
            readings = check.control_gaps(params, served, ref_cfg, chosen,
                                          dev)
            gap = readings["program"]
        else:
            gap = check.served_gaps(params, served, ref_cfg, chosen, dev)
    n_tok = sum(len(r.req.output) for r in chosen)
    marks["check"] = time.perf_counter() - t_start
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return Run(window, device_info, gap, n_tok, len(chosen), info), readings


def metrics_of(run: Run, bench: Dict[str, Any], trace: bool
               ) -> Dict[str, Dict[str, Any]]:
    """Every metric the cell reports that its reader could read."""
    out = {}
    for m in cell_metrics(bench, run.window.cell["name"], trace):
        value = reader(m["name"])(run.window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def counts(window: Window) -> Tuple[int, int]:
    """(attempted, failed): requests sent in the window, and those of
    them the engine refused or cut short."""
    sent = [r for r in window.recs.values()
            if window.t0 <= r.sent <= window.t1]
    failed = [r for r in sent if r.req.state.value in ("rejected",
                                                       "length_capped")]
    return len(sent), len(failed)
