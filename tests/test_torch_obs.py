"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``) on the same seeded inputs: the copied
metrics, export and overlap modules, the torch trace and replay, the DEP
walk's task spans under a tracer (a gloo expert group of one rank against
the reference's eager ``moe_apply_dep`` on a one-device mesh), the
executed layer trace on the CPU, the engine's tracer and default metrics
registry against the reference engine's, and the ``serve_moe`` entry
point."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.obs as jobs  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import DepClusterConfig as JaxCluster  # noqa: E402
from repro.core import dep as jdep  # noqa: E402
from repro.core import taskgraph as jtg  # noqa: E402
from repro.core.perf_model import PAPER_A6000 as JAX_A6000  # noqa: E402
from repro.core.planner import FinDEPPlanner as JaxPlanner  # noqa: E402
from repro.core.planner import PlannerConfig as JaxPlannerConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import ExecutionContext as JaxCtx  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro.sched import FinDEPPolicy as JaxPolicy  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import DepClusterConfig  # noqa: E402
from repro_torch.core import dep as tdep  # noqa: E402
from repro_torch.core import taskgraph as ttg  # noqa: E402
from repro_torch.core.perf_model import PAPER_A6000  # noqa: E402
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig  # noqa: E402
from repro_torch.launch import serve_moe  # noqa: E402
from repro_torch.obs.replay import replay_schedule  # noqa: E402
from repro_torch.obs.trace import Span, active_tracer  # noqa: E402
from repro_torch.runtime import Request, ServingEngine  # noqa: E402
from repro_torch.runtime.decode_graph import DecodeGraphs  # noqa: E402
from repro_torch.sched import FinDEPPolicy  # noqa: E402
from test_torch_decode_graph import _EagerGraph  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
#: (prompt length, new tokens) of the engine serves: one prefill bucket
#: the plan of a 2-sample memory cap chunks in two calls, slots finishing
#: one by one
REQS = ((5, 4), (20, 6), (45, 3), (40, 8))
MEM_CAP = 2


@pytest.fixture(scope="module")
def group():
    """A gloo expert group of one rank (the default process group of this
    process, over an in-process store)."""
    groups = tdep.DepGroups.single("gloo")
    yield groups
    torch.distributed.destroy_process_group()


class _Plan:
    r1, r2, order, m_e = 2, 3, "ASAS", 4


def _schedules():
    """The same lowered graph and schedule in both packages."""
    costs = dict(attn=2e-3, shared=1e-3, exp=3e-3, comm=2.5e-3)
    jg = jtg.lower(_Plan, jtg.LoweringSpec(T=2))
    tg = ttg.lower(_Plan, ttg.LoweringSpec(T=2))
    return (jtg.schedule(jg, jtg.TaskCosts(**costs)),
            ttg.schedule(tg, ttg.TaskCosts(**costs)))


def _spans_of(mod, result):
    return [mod.Span(name=t.kind, track=t.resource, start=s, end=e,
                     cat="task", args=(("kind", t.kind),
                                       ("lane", t.resource)))
            for t, s, e in result.spans()]


def _key(s):
    return (s.name, s.track, s.start, s.end, s.cat, s.args)


# ---------------------------------------------------------------------------
# metrics (a copy): buckets, quantiles, snapshot, prometheus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi,per_decade", [(1e-5, 100.0, 3),
                                              (1e-3, 10.0, 5),
                                              (0.5, 7.0, 1)])
def test_log_buckets_match_reference(lo, hi, per_decade):
    assert tobs.log_buckets(lo, hi, per_decade) == \
        jobs.log_buckets(lo, hi, per_decade)


def _values(case):
    if case == "lognormal":
        return None, np.random.RandomState(7).lognormal(-6.0, 1.5, 5000)
    if case == "edges":
        return (1.0, 10.0, 100.0), np.array([0.5, 1.0, 5.0, 10.0, 50.0,
                                            1000.0])
    return (1.0, 2.0), np.full(10, 100.0)         # overflow clamps


@pytest.mark.parametrize("case", ["lognormal", "edges", "overflow"])
def test_histogram_buckets_and_quantiles_match_reference(case):
    buckets, vals = _values(case)
    kw = {} if buckets is None else {"buckets": buckets}
    hists = [mod.Histogram("h", **kw) for mod in (tobs, jobs)]
    for h in hists:
        for v in vals:
            h.observe(float(v))
    th, jh = hists
    assert th.bucket_counts == jh.bucket_counts
    assert (th.count, th.sum) == (jh.count, jh.sum)
    for q in (0.5, 0.9, 0.99):
        assert th.quantile(q) == jh.quantile(q)
    assert (th.p50, th.p99) == (jh.p50, jh.p99)
    if case == "lognormal":          # one bucket width bounds the error
        ratio = 10 ** (1 / 3)
        for q in (0.5, 0.9, 0.99):
            exact = float(np.quantile(vals, q))
            assert exact / ratio <= th.quantile(q) <= exact * ratio
    if case == "edges":
        assert th.bucket_counts == [2, 2, 1, 1]
    if case == "overflow":
        assert th.p50 == th.p99 == 2.0


def _registry(mod):
    """One registry with every metric kind, a labelled counter with a
    value that needs escaping, a source and a reset hook."""
    m = mod.MetricsRegistry()
    state = {"x": 2.0, "resets": 0}
    m.register_source("repro_src", lambda: {"x": state["x"]})
    m.register_reset(lambda: state.__setitem__("resets",
                                               state["resets"] + 1))
    m.counter("repro_test_total", 'help with "quotes"',
              labels={"state": 'a"b\\c\nd'}).inc(3)
    m.counter("repro_test_events_total", "events").inc(4)
    m.gauge("repro_test_queue_depth", "depth").set(7.5)
    h = m.histogram("repro_test_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return m, state


def test_prometheus_text_and_parse_match_reference():
    tm, _ = _registry(tobs)
    jm, _ = _registry(jobs)
    text = tm.render_prometheus()
    assert text == jm.render_prometheus()
    samples = tobs.parse_prometheus(text)
    assert samples == jobs.parse_prometheus(text)
    by_name = {}
    for name, labels, value in samples:
        by_name.setdefault(name, []).append((labels, value))
    assert by_name["repro_test_total"] == [({"state": 'a"b\\c\nd'}, 3.0)]
    buckets = {lab["le"]: v
               for lab, v in by_name["repro_test_seconds_bucket"]}
    assert buckets == {"0.1": 1.0, "1": 2.0, "+Inf": 3.0}


def test_snapshot_jsonl_and_reset_match_reference(tmp_path):
    (tm, tstate), (jm, jstate) = _registry(tobs), _registry(jobs)
    assert tm.snapshot() == jm.snapshot()
    assert tm.snapshot()["repro_src_x"] == 2.0
    path = tmp_path / "m.jsonl"
    tm.export_jsonl(str(path))
    tm.export_jsonl(str(path))
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == 2
    snap = tm.snapshot()
    assert all(line["metrics"] == snap and line["ts"] > 0
               for line in lines)
    tm.reset()
    jm.reset()
    assert tstate["resets"] == jstate["resets"] == 1
    assert tm.snapshot() == jm.snapshot()
    assert tm.snapshot()["repro_test_events_total"] == 0.0


def test_metric_type_errors_match_reference():
    for mod in (tobs, jobs):
        m = mod.MetricsRegistry()
        c = m.counter("repro_test_events_total", "events")
        with pytest.raises(ValueError):
            c.inc(-1)
        assert m.counter("repro_test_events_total") is c
        with pytest.raises(ValueError):
            m.gauge("repro_test_events_total")


# ---------------------------------------------------------------------------
# trace: recording, scoping, lifecycles
# ---------------------------------------------------------------------------

def test_span_recording_and_disabled_noop():
    t = [0.0]
    rec = tobs.TraceRecorder(clock=lambda: t[0])
    with rec.span("phase_a", track="engine", foo=1):
        t[0] = 1.5
    assert [_key(s) for s in rec.spans] == [
        ("phase_a", "engine", 0.0, 1.5, "phase", (("foo", 1),))]
    off = tobs.TraceRecorder(enabled=False)
    with off.span("x"):
        pass
    off.instant("y")
    assert len(off) == 0
    # no fence on the CPU, and none without fence=True
    tobs.TraceRecorder(fence=True).maybe_fence(torch.ones(2))
    rec.maybe_fence(torch.ones(2))


def test_active_tracer_scoping():
    assert active_tracer() is None
    rec = tobs.TraceRecorder()
    with tobs.use_tracer(rec):
        assert active_tracer() is rec
        with tobs.use_tracer(None):
            assert active_tracer() is None
        assert active_tracer() is rec
    assert active_tracer() is None
    with tobs.use_tracer(tobs.TraceRecorder(enabled=False)):
        assert active_tracer() is None


@pytest.mark.parametrize("stamps", [(10.0, 11.0, 12.0, 14.0, 4),
                                    (10.0, 11.0, None, 11.0, 0),
                                    (3.0, None, None, 5.0, 0)],
                         ids=["full", "no-first-token", "rejected"])
def test_request_lifecycle_spans_match_reference(stamps):
    arrival, admit, first, finish, n_out = stamps
    recs = []
    for req_cls, mod in ((Request, tobs), (JaxRequest, jobs)):
        req = req_cls(prompt=[1, 2, 3], max_new_tokens=4, request_id=7)
        req.arrival_t, req.admit_t = arrival, admit
        req.first_token_t, req.finish_t = first, finish
        req.output = list(range(n_out))
        rec = mod.TraceRecorder()
        rec.request_lifecycle(req)
        recs.append([_key(s) for s in rec.by_cat("request")])
    assert recs[0] == recs[1] and recs[0]


# ---------------------------------------------------------------------------
# export (a copy, plus the device group) and validation
# ---------------------------------------------------------------------------

def _ticks():
    return iter(np.arange(0, 100, 0.5)).__next__


def test_chrome_trace_json_matches_reference():
    jres, tres = _schedules()
    objs = []
    for mod, res in ((tobs, tres), (jobs, jres)):
        rec = mod.TraceRecorder(clock=_ticks())
        with rec.span("step", step=1):
            rec.instant("mark")
        for s in _spans_of(mod, res)[:5]:
            rec.add_span(s.name, s.track, s.start, s.end, cat="task",
                         **dict(s.args))
        objs.append(mod.chrome_trace(tracer=rec, schedule=res,
                                     meta={"arch": ARCH}))
    assert json.dumps(objs[0]) == json.dumps(objs[1])
    stats = tobs.validate_chrome_trace(json.dumps(objs[0]))
    assert stats == jobs.validate_chrome_trace(objs[1])
    assert stats["complete"] == len(tres.spans()) + 1 + 5


def test_device_spans_export_on_a_group_of_their_own():
    """Spans on the card's clock go on process ``device``; the host
    group is unchanged and the whole trace validates."""
    tres = _schedules()[1]
    rec = tobs.TraceRecorder(clock=_ticks())
    with rec.span("step"):
        pass
    host = tobs.chrome_trace(tracer=rec)
    rec.device_spans = [Span(t.kind, f"device:{t.resource}", s, e, "task",
                             (("lane", t.resource),))
                        for t, s, e in tres.spans()]
    obj = tobs.chrome_trace(tracer=rec)
    names = {ev["pid"]: ev["args"]["name"] for ev in obj["traceEvents"]
             if ev.get("name") == "process_name"}
    assert names == {1: "executed", 3: "device"}
    assert obj["traceEvents"][:len(host["traceEvents"])] == \
        host["traceEvents"]
    stats = tobs.validate_chrome_trace(obj)
    assert stats["complete"] == 1 + len(tres.spans())


@pytest.mark.parametrize("events,match", [
    ([(0, 10), (5, 10)], "partially overlaps"),
    ([(0, None)], "missing key"),
    (None, "traceEvents"),
])
def test_validate_rejects_like_reference(events, match):
    if events is None:
        obj = {"noTraceEvents": []}
    else:
        obj = {"traceEvents": [
            dict({"name": "a", "ph": "X", "ts": ts, "pid": 1, "tid": 0},
                 **({} if dur is None else {"dur": dur}))
            for ts, dur in events]}
    for mod in (tobs, jobs):
        with pytest.raises(ValueError, match=match):
            mod.validate_chrome_trace(obj)
    nested = {"traceEvents": [
        {"name": n, "ph": "X", "ts": ts, "dur": d, "pid": 1, "tid": 0}
        for n, ts, d in (("o", 0, 10), ("i", 2, 3), ("n", 20, 5))]}
    assert tobs.validate_chrome_trace(nested) == \
        jobs.validate_chrome_trace(nested)


# ---------------------------------------------------------------------------
# overlap (a copy): interval algebra, exposed comm, the report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_algebra_matches_reference(seed):
    rng = np.random.RandomState(seed)

    def draw(n):
        s = rng.uniform(0, 10, n)
        return [(float(a), float(a + b))
                for a, b in zip(s, rng.uniform(0, 2, n))]
    a, b = draw(12), draw(9)
    ua, ub = tobs.interval_union(a), tobs.interval_union(b)
    assert ua == jobs.interval_union(a) and ub == jobs.interval_union(b)
    assert tobs.interval_subtract(ua, ub) == jobs.interval_subtract(ua, ub)
    assert tobs.interval_total(ua) == jobs.interval_total(ua)
    assert tobs.interval_union([(3.0, 4.0), (0.0, 2.0), (1.0, 2.5),
                                (4.0, 5.0)]) == [(0.0, 2.5), (3.0, 5.0)]


def test_attribute_overlap_matches_reference():
    """The same scheduled spans and ``ScheduleResult`` give the same
    report in both packages; fed its own schedule the gap is 0."""
    jres, tres = _schedules()
    trep = tobs.attribute_overlap(_spans_of(tobs, tres), tres)
    jrep = jobs.attribute_overlap(_spans_of(jobs, jres), jres)
    assert trep.as_dict() == jrep.as_dict()
    assert trep.gap == pytest.approx(0.0, abs=1e-12)
    assert tobs.lane_intervals(_spans_of(tobs, tres)) == \
        jobs.lane_intervals(_spans_of(jobs, jres))
    synthetic = [("ATTN", "AG", 0.0, 2.0), ("A2E", "A2E", 1.0, 3.0),
                 ("EXP", "EG", 3.0, 5.0), ("E2A", "E2A", 4.0, 7.0)]
    exp = [mod.executed_exposed_comm(
        [mod.Span(k, lane, s, e, "task", (("kind", k), ("lane", lane)))
         for k, lane, s, e in synthetic]) for mod in (tobs, jobs)]
    assert exp[0] == exp[1] == {"A2E": 1.0, "E2A": 2.0, "total": 3.0}


def test_replay_matches_schedule_within_reference_eps():
    """The torch replay on four host lanes, attributed against its own
    schedule: within the reference test's eps (0.15 of makespan), every
    task executed once; a CPU payload is waited for inside its span."""
    graph = ttg.lower(_Plan, ttg.LoweringSpec(T=2))
    costs = ttg.TaskCosts(attn=2e-3, shared=1e-3, exp=3e-3, comm=2.5e-3)
    calls = []

    def payload():
        calls.append(1)
        return torch.ones(4)
    rr = replay_schedule(graph, costs, max_wall_s=0.3,
                         payloads={"comm": payload})
    assert len(rr.spans) == len(graph.tasks)
    assert len(calls) == len(graph.tasks_of(ttg.A2E)) + \
        len(graph.tasks_of(ttg.E2A))
    rep = tobs.attribute_overlap(rr.spans, rr.scheduled,
                                 time_scale=rr.time_scale)
    assert rep.within(0.15), (rep.gap, rep.exposed_frac_executed,
                              rep.exposed_frac_modeled)
    assert rep.makespan_executed == pytest.approx(rep.makespan_modeled,
                                                  rel=0.25)
    jgraph = jtg.lower(_Plan, jtg.LoweringSpec(T=2))
    assert rr.scheduled.makespan == jtg.schedule(jgraph, jtg.TaskCosts(
        attn=2e-3, shared=1e-3, exp=3e-3, comm=2.5e-3)).makespan


# ---------------------------------------------------------------------------
# the DEP walk under a tracer
# ---------------------------------------------------------------------------

def _coords(s):
    return (s.name, s.arg("layer"), s.arg("mb"), s.arg("chunk"),
            s.arg("lane"), s.arg("emit"))


@pytest.fixture(scope="module")
def layer():
    """The smoke qwen2-moe layer (capacity factor 8: no drops) in both
    packages, from the reference's ``moe_init``, and one input."""
    cfg = jax_smoke(ARCH)
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=8.0)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), cfg.d_model, mcfg,
                       mcfg.num_experts)
    tcfg = get_smoke_config(ARCH)
    tm = dataclasses.replace(tcfg.moe, capacity_factor=8.0)
    x = np.random.RandomState(0).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jp, mcfg, tp, tm, x


@pytest.mark.parametrize("r1,r2,interleave",
                         [(r1, r2, il) for r1 in (1, 2) for r2 in (1, 2)
                          for il in ("streams", "off")])
def test_dep_walk_task_spans_match_reference(group, layer, r1, r2,
                                             interleave):
    """On a gloo group of one rank, the walk's emitted task spans equal
    the reference's eager ``moe_apply_dep`` on a one-device mesh in name,
    coordinates and order (the program's walk without GATE and ATTN);
    the output with the tracer on is bitwise the output with it off, and
    the reference's to 1e-5."""
    jp, mcfg, tp, tm, x = layer
    E = mcfg.num_experts
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jrec = jobs.TraceRecorder()
    with jobs.use_tracer(jrec):
        jy, _ = jdep.moe_apply_dep(
            jp, jnp.asarray(x), mcfg, JaxCtx(mesh=mesh, moe_impl="dep"), E,
            plan=jtg.ExecProgram(jtg.lower_exec(r2, "ASAS", 1, r1=r1),
                                 interleave))
    prog = ttg.ExecProgram(ttg.lower_exec(r2, "ASAS", 1, r1=r1), interleave)
    rec = tobs.TraceRecorder()
    with tobs.use_tracer(rec):
        ty, _ = tdep.moe_apply_dep(tp, torch.from_numpy(x), tm, group, E,
                                   plan=prog)
    off, _ = tdep.moe_apply_dep(tp, torch.from_numpy(x), tm, group, E,
                                plan=prog)
    got = [_coords(s) for s in rec.task_spans(emitted=True)]
    assert got == [_coords(s) for s in jrec.task_spans(emitted=True)]
    assert [k[0] for k in got] == [t.kind for t in prog.walk()
                                   if t.kind not in (ttg.GATE, ttg.ATTN)]
    assert rec.device_spans == [] and len(rec) == len(got)
    assert torch.equal(ty, off)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_walk_emits_task_spans_like_reference():
    """The bare walk with handlers that only record: one span per handled
    task under a tracer, the same tasks without one, and the reference's
    span names for the same graph."""
    recs, seen = [], []
    for mod, walk, graph in (
            (tobs, tdep._walk_chunk_stream, ttg.lower_exec(3, "ASAS", 1)),
            (jobs, jdep._walk_chunk_stream, jtg.lower_exec(3, "ASAS", 1))):
        log = []
        handlers = {k: log.append
                    for k in ("GATE", "A2E", "SHARED", "EXP", "E2A")}
        rec = mod.TraceRecorder()
        with mod.use_tracer(rec):
            walk(graph, handlers)
        recs.append([s.name for s in rec.task_spans(emitted=True)])
        seen.append([t.kind for t in log])
    assert recs[0] == recs[1] == seen[0] == seen[1]
    log = []
    tdep._walk_chunk_stream(ttg.lower_exec(3, "ASAS", 1),
                            {k: log.append for k in ("GATE", "A2E",
                                                     "SHARED", "EXP",
                                                     "E2A")})
    assert [t.kind for t in log] == seen[0]


@pytest.mark.parametrize("mode", ["sequence", "replicated"])
@pytest.mark.parametrize("r1,r2", [(1, 1), (2, 2)])
def test_trace_dep_execution_on_the_cpu(group, mode, r1, r2):
    """``trace_dep_execution`` on the CPU: host emission spans of every
    handled task in program order, and the output bitwise equal to the
    same call untraced."""
    prog = ttg.ExecProgram(ttg.lower_exec(r2, "AASS", 1, r1=r1), "streams")
    tr = tobs.trace_dep_execution(prog, group, mode=mode, device="cpu",
                                  seed=3)
    assert [(s.name, s.arg("mb"), s.arg("chunk")) for s in tr.spans] == [
        (t.kind, t.mb, t.chunk) for t in prog.walk()
        if t.kind not in (ttg.GATE, ttg.ATTN)]
    assert all(s.arg("emit") for s in tr.spans)
    assert tr.out.shape == (2, 4 if mode == "sequence" else 1, 32)
    assert torch.equal(tr.out, tr.untraced())
    assert tr.recorder.device_spans == [] and tr.wall_s > 0


def test_device_mesh_counterpart_needs_an_even_group(group):
    """``device_mesh`` is None where the reference's is: one rank cannot
    host a DEP exchange."""
    assert tobs.device_mesh() is None


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _jax_engine(**kw):
    cfg = jax_smoke(ARCH)
    policy = JaxPolicy(JaxPlanner(cfg, JaxCluster(8, 3, 5), JAX_A6000,
                                  JaxPlannerConfig(mem_cap_samples=MEM_CAP)))
    return JaxEngine(cfg, num_slots=4, max_context=128, seed=0,
                     plan_policy=policy, **kw)


def _engine(params, **kw):
    cfg = get_smoke_config(ARCH)
    policy = FinDEPPolicy(FinDEPPlanner(
        cfg, DepClusterConfig(8, 3, 5), PAPER_A6000,
        PlannerConfig(mem_cap_samples=MEM_CAP)))
    return ServingEngine(cfg, params=params, num_slots=4, max_context=128,
                         dtype=torch.float32, device="cpu", seed=0,
                         plan_policy=policy, **kw)


def _serve(eng, req_cls):
    rng = np.random.RandomState(0)
    reqs = [req_cls(prompt=rng.randint(1, 1000, size=n).tolist(),
                    max_new_tokens=m) for n, m in REQS]
    for r in reqs:
        eng.submit(r)
    assert len(eng.run()) == len(reqs)
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def served(group):
    """The reference engine on a one-device mesh and the port's engine on
    a gloo group of one rank, on the same weights, both traced, with
    their default registries, after serving the same requests."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jeng = _jax_engine(mesh=mesh, tracer=True)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jeng.params))
    teng = _engine(params, ep_group=group, tracer=True)
    out = dict(jeng=jeng, teng=teng, params=params,
               jtok=_serve(jeng, JaxRequest), ttok=_serve(teng, Request))
    yield out
    jeng.close()
    teng.close()


def _counts(snap):
    """The counters and histogram counts of a snapshot (what does not
    depend on either package's speed)."""
    return {k: v for k, v in snap.items()
            if k.endswith(("_total", "_count", "tracked_keys"))
            and "_time_" not in k and "_s_" not in k
            or k.startswith(("repro_engine_requests", "repro_engine_waiting",
                             "repro_engine_live", "repro_plan_cache_hits",
                             "repro_plan_cache_misses"))}


def test_engine_tokens_and_metrics_match_reference(served):
    """With ``tracer=True`` and the default registry: the reference's
    greedy tokens, the same metric names, and the same counters and
    histogram counts (requests by state, tokens, steps, plan cache,
    telemetry)."""
    teng, jeng = served["teng"], served["jeng"]
    assert served["ttok"] == served["jtok"]
    tsnap, jsnap = teng.metrics.snapshot(), jeng.metrics.snapshot()
    assert set(tsnap) == set(jsnap)
    assert _counts(tsnap) == _counts(jsnap)
    assert tsnap['repro_engine_requests_total{state="finished"}'] == \
        len(REQS)
    for name in ("repro_engine_ttft_seconds", "repro_engine_tpot_seconds",
                 "repro_engine_decode_step_seconds",
                 "repro_engine_prefill_chunk_seconds"):
        assert teng.metrics.histogram(name).count == \
            jeng.metrics.histogram(name).count > 0
    names = {n for n, _, _ in tobs.parse_prometheus(
        teng.metrics.render_prometheus())}
    assert names == {n for n, _, _ in jobs.parse_prometheus(
        jeng.metrics.render_prometheus())}


def test_engine_spans_match_reference(served):
    """The same phase spans (admit / prefill_chunk / decode_step with
    their arguments) in the same order, the same request lifecycle
    segments, and task spans of the DEP walk; the trace validates."""
    teng, jeng = served["teng"], served["jeng"]

    def phases(rec):
        return [(s.name, s.args) for s in rec.by_cat("phase")]

    def lifecycles(rec):
        return sorted((s.track, s.name) for s in rec.by_cat("request"))
    assert phases(teng.tracer) == phases(jeng.tracer)
    assert lifecycles(teng.tracer) == lifecycles(jeng.tracer)
    assert {s.name for s in teng.tracer.task_spans(emitted=True)} == \
        {"A2E", "SHARED", "EXP", "E2A"}
    stats = tobs.validate_chrome_trace(tobs.chrome_trace(teng.tracer))
    assert stats["complete"] == len(teng.tracer)


def test_tracer_off_is_bitwise_and_captures_the_same_keys(served, group):
    """Through the stand-in CUDA graph: an engine with a tracer and one
    without serve the same tokens, with the same decode logits at every
    step (bitwise), the same graph keys, captures and replays."""
    engines = []
    for tracer in (True, None):
        eng = _engine(served["params"], ep_group=group, tracer=tracer)
        eng.decode_graph = True
        eng._graphs = DecodeGraphs(eng._step, _EagerGraph, eng.stats)
        engines.append(eng)
    rng = np.random.RandomState(0)
    for n, m in REQS:
        prompt = rng.randint(1, 1000, size=n).tolist()
        for eng in engines:
            eng.submit(Request(prompt=prompt, max_new_tokens=m))
    on, off = engines
    while True:
        busy = [eng.step() for eng in engines]
        assert busy[0] == busy[1]
        if on.last_logits is not None:
            assert torch.equal(on.last_logits, off.last_logits)
        if not busy[0] and not on.waiting:
            break
    assert [r.output for r in on.finished] == [r.output for r in off.finished]
    assert set(on._graphs.graphs) == set(off._graphs.graphs)
    assert (on.stats.graph_captures, on.stats.graph_replays) == \
        (off.stats.graph_captures, off.stats.graph_replays)
    assert on.tracer.task_spans(emitted=True) and off.tracer is None


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_reset_stats_clears_every_surface(served, kv_layout):
    """``reset_stats()`` (the registry's reset) zeroes the engine's
    counters, every histogram, the telemetry, the paging counters and
    the tracer; the graphs' capture count stays."""
    eng = _engine(served["params"], tracer=True, kv_layout=kv_layout,
                  kv_block_size=16)
    _serve(eng, Request)
    m = eng.metrics
    assert eng.telemetry.phases and len(eng.tracer)
    if kv_layout == "paged":
        assert m.snapshot()["repro_paging_prefix_miss_tokens"] > 0
    eng.reset_stats()
    snap = m.snapshot()
    st = eng.stats
    assert (st.steps, st.prefill_calls, st.decode_tokens, st.start_t) == \
        (0, 0, 0, None)
    assert not eng.telemetry.phases and not eng.telemetry.keys
    assert all(snap[f"repro_engine_{n}_seconds_count"] == 0
               for n in ("ttft", "tpot", "decode_step", "prefill_chunk"))
    assert snap['repro_engine_requests_total{state="finished"}'] == 0
    assert len(eng.tracer) == 0
    if kv_layout == "paged":
        assert snap["repro_paging_prefix_miss_tokens"] == 0


def test_metrics_false_disables_and_tracer_off_by_default(served):
    eng = _engine(served["params"], metrics=False)
    assert eng.metrics is None and eng.tracer is None
    assert _serve(eng, Request) == served["ttok"]
    eng.reset_stats()            # still resets the direct surfaces
    assert eng.stats.steps == 0 and not eng.telemetry.phases


def test_drift_and_refresh_count_into_the_registry(served):
    """``metrics=`` reaches the drift monitor and its refresher: their
    counters and the drift source are in the engine's registry."""
    eng = _engine(served["params"], drift_threshold=0.01,
                  drift_min_samples=1)
    _serve(eng, Request)
    eng.drift.refresher.drain()
    snap = eng.metrics.snapshot()
    eng.close()
    assert snap["repro_drift_observations_total"] == \
        eng.drift.stats.observations > 0
    assert snap["repro_drift_events_total"] == eng.drift.stats.drift_events
    assert snap["repro_plan_refresh_completed_total"] == \
        eng.drift.refresher.completed


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dep", [False, True], ids=["capacity", "dep"])
def test_serve_moe_writes_a_valid_trace_and_metrics(group, tmp_path, dep,
                                                    capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    argv = ["--device", "cpu", "--requests", "4", "--max-new", "4",
            "--trace-out", str(trace), "--metrics-out", str(metrics),
            "--profile-store", str(tmp_path / "store")]
    out = serve_moe.main(argv + (["--dep"] if dep else []))
    eng = out.engine
    assert len(out.finished) == 4
    assert (eng.model.ctx.moe_impl == "dep") == dep
    stats = tobs.validate_chrome_trace(trace.read_text())
    assert stats["complete"] == len(eng.tracer)
    assert any(s.cat == "task" for s in eng.tracer.spans) == dep
    line = json.loads(metrics.read_text().splitlines()[-1])["metrics"]
    assert line["repro_engine_ttft_seconds_count"] == 4
    assert line['repro_engine_requests_total{state="finished"}'] == 4
    printed = capsys.readouterr().out
    assert "TTFT p50" in printed and "TPOT p50" in printed
    assert f"wrote trace {trace}" in printed


@pytest.mark.parametrize("flag", [["--replicate-hot-k", "2"],
                                  ["--rebalance-threshold", "1.5"]])
def test_serve_moe_placement_flags_raise_until_ported(flag):
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        serve_moe.main(["--device", "cpu", "--requests", "1"] + flag)


def test_serve_moe_tokens_match_the_engine(served, tmp_path):
    """The entry point's requests through an untraced twin on the same
    weights give the same greedy tokens."""
    argv = ["--device", "cpu", "--requests", "4", "--max-new", "4",
            "--profile-store", str(tmp_path / "store")]
    out = serve_moe.main(argv + ["--trace-out", str(tmp_path / "t.json")])
    args = serve_moe.build_parser().parse_args(argv)
    twin = serve_moe.serve(args, serve_moe.build_engine(
        args, params=out.engine.params, tracer=None, metrics=False))
    greedy = [i for i, r in enumerate(out.requests) if r.temperature == 0]
    assert greedy
    assert [out.requests[i].output for i in greedy] == \
        [twin.requests[i].output for i in greedy]
