"""The port's measured cost models (``repro_torch.profiling``) held
against ``repro.profiling`` on the CPU: the copies (``StepTimer``,
``fit_primitive_scales``, ``DriftMonitor``/``PlanRefresher``,
``PeriodicRecalibrator``) driven with the same inputs as their originals
give the same results; the torch microbenchmarks emit the reference's
units; a profile stored by either package loads bit for bit in the other
and solves the same plans; two gloo ranks measure a live
``all_to_all_single``; and the engine, given a stored or a freshly
calibrated profile, plans and serves as the reference engine given the
same profile, drifts and re-solves in the background, and keeps a
calibration job off the card while it captures a decode graph."""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import profiling as ref  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import DepClusterConfig as JaxCluster  # noqa: E402
from repro.core import perf_model as jax_perf  # noqa: E402
from repro.core.planner import FinDEPPlanner as JaxPlanner  # noqa: E402
from repro.core.planner import PlannerConfig as JaxPlannerConfig  # noqa: E402
from repro.core.solver import Plan as JaxPlan  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro.sched import FinDEPPolicy as JaxPolicy  # noqa: E402
from repro.sched import PlanCache as JaxPlanCache  # noqa: E402
from repro_torch import profiling as port  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import DepClusterConfig  # noqa: E402
from repro_torch.core import perf_model  # noqa: E402
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig  # noqa: E402
from repro_torch.core.solver import Plan  # noqa: E402
from repro_torch.runtime import Request, ServingEngine  # noqa: E402
from repro_torch.runtime.decode_graph import DecodeGraphs  # noqa: E402
from repro_torch.sched import FinDEPPolicy, PlanCache  # noqa: E402
from test_torch_decode_graph import _EagerGraph  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: one bucket of four prompts, chunked by a 2-sample memory cap, with
#: slots finishing one by one (as ``test_torch_engine_dep.py``)
REQS = ((5, 4), (20, 6), (45, 3), (40, 8))
MEM_CAP = 2

#: the two packages side by side: each scenario runs on both
LIBS = {
    "port": SimpleNamespace(p=port, Plan=Plan, PlanCache=PlanCache,
                            perf=perf_model, Policy=FinDEPPolicy,
                            planner=lambda hw: FinDEPPlanner(
                                get_smoke_config(ARCH),
                                DepClusterConfig(8, 3, 5), hw,
                                PlannerConfig(mem_cap_samples=8))),
    "ref": SimpleNamespace(p=ref, Plan=JaxPlan, PlanCache=JaxPlanCache,
                           perf=jax_perf, Policy=JaxPolicy,
                           planner=lambda hw: JaxPlanner(
                               jax_smoke(ARCH), JaxCluster(8, 3, 5), hw,
                               JaxPlannerConfig(mem_cap_samples=8))),
}


def _both(scenario):
    """``scenario(lib)`` on the port and on the reference."""
    return scenario(LIBS["port"]), scenario(LIBS["ref"])


def synthetic_measured():
    """An exactly-linear 'measurement' set (the reference's tests')."""
    xs = np.linspace(1e6, 1e9, 8)
    ys = np.linspace(1e5, 1e8, 8)
    zs = np.linspace(2 ** 16, 2 ** 24, 8)
    return {"gemm": (xs, 1.7e-4 + 8.6e-14 * xs),
            "attn": (ys, 1.5e-4 + 1.5e-14 * ys),
            "comm": (zs, 3.7e-4 + 2.5e-9 * zs),
            "decode": (zs, 2.0e-4 + 5.0e-9 * zs)}


def _samples(measured):
    return {k: (list(map(float, xs)), list(map(float, ts)))
            for k, (xs, ts) in measured.items()}


# ---------------------------------------------------------------------------
# telemetry and attribution (copies)
# ---------------------------------------------------------------------------

def _timer_run(lib):
    """A seeded stream of observations over two phases and four keys:
    predictions missing, zero or positive, breakdowns on some, a key
    reset now and then."""
    rng = np.random.RandomState(0)
    timer = lib.p.StepTimer(smoothing=0.5, key_warmup=1)
    residuals = []
    for i in range(200):
        phase = ("prefill", "decode")[rng.randint(2)]
        key = ("k", int(rng.randint(4)))
        measured = float(rng.uniform(0.5, 2.0))
        predicted = (None, 0.0, float(rng.uniform(0.5, 2.0)))[
            rng.choice(3, p=(0.1, 0.1, 0.8))]
        bd = None
        if rng.rand() < 0.6:
            bd = dict(zip(("gemm", "attn", "comm"), rng.uniform(0, 1, 3)))
        residuals.append(timer.observe(phase, measured, predicted_s=predicted,
                                       key=key, breakdown=bd))
        if i % 37 == 36:
            timer.reset_key(("k", int(rng.randint(4))))
    keys = {k: dataclasses.asdict(st) for k, st in timer.keys.items()}
    return (residuals, timer.summary(), timer.snapshot(), keys,
            timer.residuals(), repr(timer))


def test_step_timer_copy_equals_original():
    """Residuals, per-phase sums, per-key EWMAs, key warm-up, breakdown
    sums and resets: bitwise the original's on one observation stream."""
    got, want = _both(_timer_run)
    assert got == want
    residuals, _, _, keys, _, _ = got
    assert any(r is None for r in residuals)
    assert any(st["breakdown"] for st in keys.values())


def test_step_timer_key_warmup_and_breakdown():
    """A key's first observation (the capture of its graph) stays out of
    its EWMA and sums; later breakdowns accumulate."""
    def run(lib):
        timer = lib.p.StepTimer(key_warmup=1)
        bd = {"gemm": 0.6, "attn": 0.3, "comm": 0.1}
        timer.observe("decode", 100.0, predicted_s=1.0, key="k",
                      breakdown=bd)
        first = (timer.key_residual("k"), dict(timer.keys["k"].breakdown))
        for _ in range(2):
            timer.observe("decode", 2.0, predicted_s=1.0, key="k",
                          breakdown=bd)
        return first, dataclasses.asdict(timer.keys["k"])
    got, want = _both(run)
    assert got == want
    (first_res, first_bd), st = got
    assert first_res is None and first_bd == {}
    assert st["count"] == 2 and st["residual_ewma"] == 1.0
    assert st["breakdown"]["gemm"] == pytest.approx(1.2)


def test_fit_primitive_scales_copy_equals_original():
    """Known scales are recovered; the unidentifiable cases (one
    composition, too few rows, none) give None; a zero-signal primitive
    keeps 1.0; and seeded random rows fit to the original's bits."""
    true = {"gemm": 1.0, "attn": 1.3, "comm": 2.0}
    comps = [(1.0, 0.5, 0.2), (0.3, 0.2, 1.5), (0.5, 1.0, 0.1),
             (0.9, 0.1, 0.9)]
    known = [({"gemm": g, "attn": a, "comm": c},
              true["gemm"] * g + true["attn"] * a + true["comm"] * c)
             for g, a, c in comps]
    row = ({"gemm": 1.0, "attn": 0.5, "comm": 0.2}, 2.0)
    zero_attn = [({"gemm": 1.0, "attn": 0.0, "comm": 0.5}, 2.0),
                 ({"gemm": 0.2, "attn": 0.0, "comm": 1.5}, 3.2)]
    rng = np.random.RandomState(1)
    noisy = [(dict(zip(("gemm", "attn", "comm"), rng.uniform(0.1, 1, 3))),
              float(rng.uniform(1, 3))) for _ in range(6)]
    cases = [known, [row, row, row], [row], [], zero_attn, noisy]
    got = [port.fit_primitive_scales(c) for c in cases]
    assert got == [ref.fit_primitive_scales(c) for c in cases]
    for k, v in true.items():
        assert got[0][k] == pytest.approx(v, rel=1e-9)
    assert got[1] is None and got[2] is None and got[3] is None
    assert got[4]["attn"] == 1.0
    assert got[4]["comm"] == pytest.approx(2.0, rel=1e-9)
    timer = port.StepTimer(key_warmup=0)
    jtimer = ref.StepTimer(key_warmup=0)
    for t in (timer, jtimer):
        for i, (bd, m) in enumerate(known):
            t.observe("decode", m, predicted_s=1.0, key=i, breakdown=bd)
    assert port.attribution_rows(timer.keys) == \
        ref.attribution_rows(jtimer.keys)


# ---------------------------------------------------------------------------
# drift refresh (copies)
# ---------------------------------------------------------------------------

def _slow_policy(lib, delay=0.5):
    """First resolve is instant; every later one sleeps (a solver
    hiccup) and bumps r2, so a refreshed plan is told apart."""
    pol = SimpleNamespace(name="slowrefresh", calls=0)

    def resolve(phase, seq_bucket=None, batch_per_device=None, *,
                occupancy=None):
        pol.calls += 1
        if pol.calls > 1:
            time.sleep(delay)
        return lib.Plan(m_a=1, r1=1, m_e=1.0, r2=pol.calls, order="AASS",
                        throughput=1.0, makespan=1.0)
    pol.resolve = resolve
    return pol


def _synthetic_drift(lib):
    """The reference's synthetic drift: one key's measured time doubles
    its prediction; the slow solver's re-solve runs in the background."""
    pol = _slow_policy(lib)
    cache = lib.PlanCache(pol)
    monitor = lib.p.DriftMonitor(cache, threshold=0.3, min_samples=2,
                                 recalibrate=False)
    try:
        stale = cache.get("decode", 256, 4)
        key = ("decode", 256, 4)
        t0 = time.perf_counter()
        fired = [monitor.observe(key, measured_s=m, predicted_s=1.0)
                 for m in (9.0, 2.0, 2.0)]
        observe_s = time.perf_counter() - t0
        serving = cache.get("decode", 256, 4) is stale
        fired.append(monitor.observe(key, measured_s=2.0, predicted_s=1.0))
        monitor.refresher.drain()
        return dict(fired=fired, never_blocked=observe_s < 0.25,
                    stale_served=serving, calls=pol.calls,
                    r2=cache.get("decode", 256, 4).r2,
                    refreshes=cache.stats.refreshes,
                    events=monitor.stats.drift_events,
                    completed=monitor.refresher.completed,
                    restarted=monitor.timer.key_residual(key) is None)
    finally:
        monitor.close()


def test_drift_one_resolve_never_blocks():
    """A breach schedules exactly one background re-solve; the stale
    plan serves meanwhile, the observe path never waits on the solve,
    and a breach while it is in flight is dropped, as in the original."""
    got, want = _both(_synthetic_drift)
    assert got == want
    assert got == dict(fired=[False, False, True, False], never_blocked=True,
                       stale_served=True, calls=2, r2=2, refreshes=1,
                       events=1, completed=1, restarted=True)


def _comm_drift(lib):
    """Comm runs 2x its model, compute on time, over three keys of
    different compositions: the episode retunes comm alone."""
    planner = lib.planner(lib.perf.PAPER_A6000)
    cache = lib.PlanCache(lib.Policy(planner))
    monitor = lib.p.DriftMonitor(cache, threshold=0.2, min_samples=2,
                                 recalibrate=True, per_primitive=True)
    comps = {("decode", 256, 1): (0.8, 0.15, 0.05),
             ("decode", 256, 2): (0.1, 0.1, 0.8),
             ("decode", 256, 4): (0.3, 0.6, 0.1)}
    try:
        for _, s, b in comps:
            cache.get("decode", s, b)
        for _ in range(4):
            for key, (g, a, c) in comps.items():
                monitor.observe(key, g + a + 2.0 * c, 1.0,
                                breakdown={"gemm": g, "attn": a, "comm": c})
        monitor.refresher.drain()
        hw = planner.hardware
        return dict(events=monitor.stats.drift_events,
                    scales=monitor.stats.last_scales,
                    hardware=dataclasses.asdict(hw),
                    plans={repr(k): p.as_dict()
                           for k, p in cache.entries().items()})
    finally:
        monitor.close()


def test_drift_rescales_comm_per_primitive():
    got, want = _both(_comm_drift)
    assert got == want
    a6000 = perf_model.PAPER_A6000
    assert got["events"] >= 1
    assert got["scales"]["comm"] == pytest.approx(2.0, rel=1e-6)
    assert got["scales"]["gemm"] == pytest.approx(1.0, rel=1e-6)
    assert got["hardware"]["comm"]["beta"] == \
        pytest.approx(2.0 * a6000.comm.beta, rel=1e-6)
    assert got["hardware"]["gemm"]["beta"] == \
        pytest.approx(a6000.gemm.beta, rel=1e-6)


def test_refresher_dedups_and_contains_errors():
    def run(lib):
        boom = SimpleNamespace(name="boom")

        def resolve(*a, **k):
            raise RuntimeError("solver exploded")
        boom.resolve = resolve
        r = lib.p.PlanRefresher(lib.PlanCache(boom))
        gate = threading.Event()
        first = r.request_job("job", gate.wait)
        second = r.request_job("job", gate.wait)
        pending = r.pending()
        gate.set()
        r.request(("decode", 1, 1))
        r.drain(timeout=10)
        r.close()
        return first, second, pending, r.completed, r.failed
    got, want = _both(run)
    assert got == want == (True, False, 1, 1, 1)


def _stub_result(lib, name="recal"):
    profile, r2s = lib.perf.fit_profile(synthetic_measured(), name=name)
    samples = {k: lib.p.MicrobenchSamples(k, xs, ts, proxy=(k == "comm"))
               for k, (xs, ts) in _samples(synthetic_measured()).items()}
    return lib.p.CalibrationResult(profile=profile, fit_r2=r2s,
                                   samples=samples, wall_s=0.01)


def _recalibrator_run(lib, root):
    planner = lib.planner(lib.perf.PAPER_A6000)
    cache = lib.PlanCache(lib.Policy(planner))
    cache.get("prefill", 256, 4)
    store = lib.p.ProfileStore(root)
    result = _stub_result(lib)
    recal = lib.p.PeriodicRecalibrator(
        cache, store, key=lib.p.ProfileKey("cpu", (1,), "float32"),
        max_age_s=3600.0, calibrate_fn=lambda: result, poll_interval_s=0.0)
    try:
        steps = [recal.due(), recal.maybe_recalibrate()]
        recal.drain()
        steps += [recal.recalibrations, recal.due(),
                  recal.maybe_recalibrate()]
        steps += [recal.maybe_recalibrate(force=True)]
        recal.drain()
        stored = store.get_for_key(recal.key)
        return dict(steps=steps + [recal.recalibrations],
                    stored=dataclasses.asdict(stored.profile),
                    comm_proxy=stored.comm_proxy,
                    hardware=dataclasses.asdict(planner.hardware),
                    refreshes=cache.stats.refreshes,
                    plan=cache.get("prefill", 256, 4).as_dict())
    finally:
        recal.close()


def test_periodic_recalibrator_copy_equals_original(tmp_path):
    """A stub calibration: due on an empty store, one background run that
    stores the fit, reprofiles the policy and re-solves the cached plan;
    not due once fresh; a forced run dedups through the worker."""
    got = _recalibrator_run(LIBS["port"], tmp_path / "port")
    want = _recalibrator_run(LIBS["ref"], tmp_path / "ref")
    assert got == want
    assert got["steps"] == [True, True, 1, False, False, True, 2]
    assert got["stored"] == got["hardware"] and got["comm_proxy"]
    assert got["refreshes"] == 2


# ---------------------------------------------------------------------------
# microbenchmarks and the store
# ---------------------------------------------------------------------------

def test_microbench_units_equal_reference():
    """Each primitive's x, in perf_model's units, and its proxy flag on
    the CPU are the reference's for the same sweep; every time is > 0."""
    import jax.numpy as jnp
    sweeps = dict(gemm=[(8, 16, 32), (16, 16, 32)], attn=[(2, 16, 4, 8)],
                  comm=[1 << 12, 1 << 14], decode=[(2, 64, 0.5), (1, 8, 1.0)])
    kw = dict(warmup=0, iters=1)
    got = [port.measure_gemm(sweeps["gemm"], device="cpu", **kw),
           port.measure_attention(sweeps["attn"], device="cpu", **kw),
           port.measure_all_to_all(None, sweeps["comm"], device="cpu",
                                   dtype=torch.float32, **kw),
           port.measure_decode_attention(sweeps["decode"], device="cpu",
                                         **kw)]
    want = [ref.measure_gemm(sweeps["gemm"], **kw),
            ref.measure_attention(sweeps["attn"], **kw),
            ref.measure_all_to_all(None, sizes_bytes=sweeps["comm"],
                                   dtype=jnp.float32, **kw),
            ref.measure_decode_attention(sweeps["decode"], **kw)]
    for g, w in zip(got, want):
        assert (g.kind, g.xs, g.proxy) == (w.kind, w.xs, w.proxy)
        assert len(g.ts) == len(g.xs) and all(t > 0 for t in g.ts)
    assert got[0].xs == [8 * 16 * 32, 16 * 16 * 32]
    assert got[1].xs == [4 * 2 * 16 * 16 * (8 + 8)]
    assert got[2].proxy and got[2].xs == [float(1 << 12), float(1 << 14)]
    assert got[3].proxy and got[3].xs[0] == 2.0 * 32 * 4 * 2 * 64 * 4
    assert got[3].xs[1] == 1.0 * 16 * 4 * 2 * 64 * 4      # c_eff >= 16
    bf16 = port.measure_decode_attention([(2, 64, 0.5)], device="cpu",
                                         dtype=torch.bfloat16, **kw)
    assert bf16.xs == [got[3].xs[0] / 2]


def test_card_sweeps_cover_serving_shapes():
    """The card's sweeps span two decades of each unit and reach the
    qwen2-moe serving shapes' work; the CPU keeps the reference's."""
    card = port.CARD_SWEEPS
    gemm = [m * k * n for m, k, n in card.gemm]
    attn = [H * B * S * S * 2 * D for B, S, H, D in card.attn]
    kv, d = card.decode_heads
    dec = [B * int(C * f) * kv * 2 * d * 2 for B, C, f in card.decode]
    for xs in (gemm, attn, dec, card.comm):
        assert list(xs) == sorted(xs) and xs[-1] >= 100 * xs[0]
    assert gemm[-1] >= 60 * 204 * 2048 * 1408 * 3
    assert attn[-1] >= 16 * 1 * 1024 ** 2 * 256
    assert dec[-1] >= 8 * 1024 * 16 * 256 * 2 and (kv, d) == (16, 128)
    cpu = torch.device("cpu")
    assert port.sweeps_for(cpu, fast=True).gemm == ref.GEMM_SWEEP_FAST
    assert port.sweeps_for(cpu, fast=False).attn == ref.ATTN_SWEEP
    assert port.sweeps_for(cpu, fast=True).comm == ref.COMM_SWEEP_BYTES_FAST
    assert port.sweeps_for(cpu, fast=False).decode == ref.DECODE_SWEEP


def test_store_round_trip_across_packages(tmp_path):
    """A profile stored by the port loads bit for bit in the port and in
    the reference (and back): the same schema, key and samples; plans
    solved from the loaded fit equal those from the fresh fit and the
    reference's on it. The keys of this host agree on the CPU."""
    profile, r2s = perf_model.fit_profile(synthetic_measured(), name="rt")
    key = port.ProfileKey.for_host(None, torch.float32, "cpu")
    assert key.as_dict() == ref.ProfileKey.for_host(None).as_dict()
    assert port.ProfileKey.for_host(dtype=torch.bfloat16,
                                    device="cpu").dtype == "bfloat16"
    samples = _samples(synthetic_measured())
    pstore = port.ProfileStore(tmp_path)
    pstore.put(profile, key, name="rt", fit_r2=r2s, samples=samples)
    entry = pstore.get("rt")
    jentry = ref.ProfileStore(tmp_path).get("rt")
    assert entry.profile == profile
    assert dataclasses.asdict(jentry.profile) == dataclasses.asdict(profile)
    assert entry.samples == samples == jentry.samples
    assert entry.fit_r2 == r2s == jentry.fit_r2
    assert jentry.key.as_dict() == key.as_dict()
    assert pstore.get_for_key(key).name == "rt"
    assert not entry.is_stale(3600) and entry.is_stale(0)
    fresh = LIBS["port"].planner(profile).plan(256, 4)
    assert LIBS["port"].planner(entry.profile).plan(256, 4) == fresh
    assert LIBS["ref"].planner(jentry.profile).plan(256, 4).as_dict() == \
        fresh.as_dict()
    ref.ProfileStore(tmp_path).put(jentry.profile, jentry.key, name="back")
    assert pstore.load_profile("back") == profile
    (tmp_path / "bad.json").write_text('{"schema": 999, "name": "bad"}')
    assert pstore.names() == ref.ProfileStore(tmp_path).names() == \
        ["back", "rt"]
    with pytest.raises(KeyError, match="schema"):
        pstore.get("bad")


def test_calibrate_on_cpu_stores_its_fit(tmp_path):
    """``calibrate`` on the CPU: the reference's fast sweeps, every
    primitive fitted, comm and decode flagged as proxies; the stored
    result loads back bit for bit."""
    res = port.calibrate(name="cpu-fit", fast=True, device="cpu")
    assert set(res.fit_r2) == set(port.MICROBENCH_KINDS)
    assert res.comm_is_proxy and res.samples["decode"].proxy
    assert not res.samples["gemm"].proxy
    assert res.samples["gemm"].xs == \
        [float(m * k * n) for m, k, n in ref.GEMM_SWEEP_FAST]
    assert all(0 <= n <= 2 for n in res.retries.values())
    store = port.ProfileStore(tmp_path)
    entry = store.put_calibration(
        res, port.ProfileKey.for_host(None, torch.float32, "cpu"))
    again = store.get(entry.name)
    assert again.profile == res.profile and again.comm_proxy
    assert again.fit_r2 == res.fit_r2


_A2A_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
from repro_torch.core.dep import DepGroups
from repro_torch.profiling import calibrate, measure_all_to_all

torch.set_num_threads(1)
d, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=2)
groups = DepGroups.build(1, 2)
s = measure_all_to_all(groups, sizes_bytes=[1 << 12, 1 << 16],
                       dtype=torch.float32, device="cpu", warmup=0, iters=1)
x = torch.full((2, 3), float(rank)) + torch.arange(2.0)[:, None] * 10
got = torch.empty_like(x)
dist.all_to_all_single(got, x, group=groups.expert)
res = calibrate(fast=True, groups=groups, device="cpu", min_r2=1.01,
                max_retries=1)
print(json.dumps(dict(xs=s.xs, proxy=s.proxy, n=len(s.ts),
                      positive=all(t > 0 for t in s.ts),
                      got=got.tolist(), comm_proxy=res.comm_is_proxy,
                      retries=res.retries)))
dist.destroy_process_group()
"""


def test_all_to_all_on_two_gloo_ranks(tmp_path):
    """An expert group of two gloo ranks: ``measure_all_to_all`` times a
    live ``all_to_all_single`` (``proxy=False``) with z = mo·c·itemsize
    bytes per rank, and ``calibrate`` fits it as a wire measurement;
    with an unreachable ``min_r2`` both ranks re-measure every primitive
    once, together."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _A2A_WORKER,
                               str(tmp_path), str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for rank, o in enumerate(outs):
        # 4096 B of f32: 1024 elements, c = 512 per peer
        assert o["xs"] == [2.0 * 512 * 4, 2.0 * 8192 * 4]
        assert not o["proxy"] and o["n"] == 2 and o["positive"]
        assert o["got"] == [[0.0 + 10 * rank] * 3, [1.0 + 10 * rank] * 3]
        assert not o["comm_proxy"]
        assert o["retries"] == {k: 1 for k in port.MICROBENCH_KINDS}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _jax_engine(**kw):
    cfg = jax_smoke(ARCH)
    policy = JaxPolicy(JaxPlanner(
        cfg, JaxCluster(8, 3, 5), jax_perf.PAPER_A6000,
        JaxPlannerConfig(mem_cap_samples=MEM_CAP)))
    return JaxEngine(cfg, num_slots=4, max_context=128, seed=0,
                     plan_policy=policy, **kw)


def _engine(params, **kw):
    cfg = get_smoke_config(ARCH)
    policy = FinDEPPolicy(FinDEPPlanner(
        cfg, DepClusterConfig(8, 3, 5), perf_model.PAPER_A6000,
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


def _plans(eng):
    return {repr(k): p.as_dict() for k, p in eng.resolved_plans().items()}


def _telemetry_keys(eng):
    return {repr(k): (st.count, st.predicted_s)
            for k, st in eng.telemetry.keys.items()}


@pytest.fixture(scope="module")
def params():
    """The reference engine's weights, and the port's copy of them."""
    jparams = _jax_engine().params
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams))


def test_engine_stored_profile_matches_reference(params, tmp_path):
    """``profile=<name>`` from a store the port wrote: the planner runs on
    the stored fit bit for bit, and the engine's plans, greedy tokens and
    telemetry keys (observations and predicted seconds per plan key)
    equal the reference engine's, given the same name and store."""
    jparams, tparams = params
    profile, r2s = perf_model.fit_profile(synthetic_measured(),
                                          name="stored_for_engine")
    port.ProfileStore(tmp_path).put(
        profile, port.ProfileKey("cpu", (1,), "float32"),
        name="stored_for_engine", fit_r2=r2s)
    teng = _engine(tparams, profile="stored_for_engine",
                   profile_store=tmp_path)
    jeng = _jax_engine(params=jparams, profile="stored_for_engine",
                       profile_store=str(tmp_path))
    try:
        assert teng.plan_policy.planner.hardware == profile
        assert dataclasses.asdict(jeng.plan_policy.planner.hardware) == \
            dataclasses.asdict(profile)
        assert _serve(teng, Request) == _serve(jeng, JaxRequest)
        assert _plans(teng) == _plans(jeng)
        assert _telemetry_keys(teng) == _telemetry_keys(jeng)
        res = teng.telemetry.residuals()
        assert res["prefill"] is not None and res["decode"] is not None
        assert teng.telemetry.phases["prefill"].count == \
            teng.stats.prefill_calls
        assert teng.telemetry.phases["decode"].count == teng.stats.steps
    finally:
        teng.close()
        jeng.close()


def test_engine_calibrate_matches_reference_on_its_fit(params, tmp_path):
    """``calibrate=True``: the engine measures on its device at its dtype,
    stores the fit under this host's key, and plans from it; the
    reference engine, given that stored profile by name, resolves the
    same plans and serves the same greedy tokens, as does a second port
    engine given the name."""
    jparams, tparams = params
    teng = _engine(tparams, calibrate=True, profile_store=tmp_path)
    try:
        key = port.ProfileKey.for_host(None, torch.float32, "cpu")
        assert teng.calibration is not None
        entry = port.ProfileStore(tmp_path).get_for_key(key)
        assert entry.name == key.slug()
        assert entry.profile == teng.calibration.profile == \
            teng.plan_policy.planner.hardware
        tokens = _serve(teng, Request)
    finally:
        teng.close()
    again = _engine(tparams, profile=key.slug(), profile_store=tmp_path)
    jeng = _jax_engine(params=jparams, profile=key.slug(),
                       profile_store=str(tmp_path))
    try:
        assert _serve(again, Request) == tokens == _serve(jeng, JaxRequest)
        assert _plans(again) == _plans(teng) == _plans(jeng)
    finally:
        again.close()
        jeng.close()


def test_engine_drift_and_recalibration_end_to_end(params, tmp_path):
    """A profile that under-predicts by orders of magnitude trips drift:
    re-solves run in the background and every request finishes; a
    stale store (max age 0) recalibrates on the worker while serving,
    reprofiles the policy and re-solves the cached plans."""
    _, tparams = params
    calls = []
    hw = perf_model.PAPER_A6000.scaled(1e-5, name="way_too_fast")
    # the background calibration measures a card as far off the model
    recal = dataclasses.replace(_stub_result(LIBS["port"]),
                                profile=hw.scaled(1.0, name="recal"))

    def stub():
        calls.append(threading.current_thread().name)
        return recal

    eng = _engine(tparams, profile=hw, profile_store=tmp_path,
                  drift_threshold=0.5, drift_min_samples=1,
                  recalibrate_max_age_s=0.0)
    eng.recalibrator.calibrate_fn = stub
    try:
        assert eng.plan_policy.planner.hardware is hw
        assert eng.recalibrator.key == port.ProfileKey("cpu", (1,),
                                                       "float32")
        assert len(_serve(eng, Request)) == len(REQS)
        eng.drift.refresher.drain()
        assert eng.drift.stats.drift_events >= 1
        assert eng.recalibrator.recalibrations == 1 == len(calls)
        assert calls[0].startswith("plan-refresh")
        assert eng.plan_cache.stats.refreshes >= 1
        assert eng.drift.refresher.failed == 0
        assert port.ProfileStore(tmp_path).get("cpu_1_float32").profile \
            == recal.profile
        assert eng.telemetry.residuals()["decode"] is not None
    finally:
        eng.close()


def test_capture_waits_for_calibration_job(params):
    """A calibration job holds the engine's device lock: a decode step
    whose graph key is new (a capture) waits for it, and a replay of a
    captured key does not."""
    _, tparams = params
    eng = _engine(tparams, telemetry=False)
    eng.decode_graph = True
    eng._graphs = graphs = DecodeGraphs(eng._step, _EagerGraph, eng.stats)
    eng.submit(Request(prompt=[1, 2, 3, 4, 5], max_new_tokens=4))
    assert eng.step()                  # warm-up, then the first capture
    assert eng.telemetry is None and len(graphs.graphs) == 1
    done = []
    with eng._device_lock:             # a calibration job in flight
        t = threading.Thread(target=lambda: done.append(eng.step()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and done == [True]   # a replay: no wait
        graphs.graphs.clear()          # the next key is new: a capture
        t = threading.Thread(target=lambda: done.append(eng.step()))
        t.start()
        t.join(timeout=0.5)
        assert t.is_alive()            # waits for the lock
    t.join(timeout=10)
    assert not t.is_alive() and done == [True, True]
    assert eng.stats.graph_captures == 2


def test_calibrate_fit_holds_intercepts_nonnegative():
    """``calibrate``'s fit is the reference's least-squares line where its
    intercept is >= 0, and the line through the origin where it is not
    (a negative time for small work would reach the planner's task
    costs)."""
    from repro.core.perf_model import fit_alpha_beta as jax_fit
    xs = [1.0, 2.0, 4.0, 8.0]
    up = [3.0 + 2.0 * x for x in xs]
    down = [0.0, 1.0, 6.0, 20.0]              # least squares: alpha < 0
    ab, r2 = port.microbench.fit_nonnegative(xs, up)
    want, want_r2 = jax_fit(xs, up)
    assert (ab.alpha, ab.beta, r2) == (want.alpha, want.beta, want_r2)
    assert jax_fit(xs, down)[0].alpha < 0
    ab, r2 = port.microbench.fit_nonnegative(xs, down)
    x, t = np.asarray(xs), np.asarray(down)
    assert ab.alpha == 0.0 and ab.beta == pytest.approx(x @ t / (x @ x))
    assert 0.8 < r2 < jax_fit(xs, down)[1]      # the constraint costs fit
    samples = {k: port.MicrobenchSamples(k, xs, down if k == "attn" else up)
               for k in port.MICROBENCH_KINDS}
    profile, r2s = port.microbench.fit_samples(samples, "f")
    assert profile.attn.alpha == 0.0
    assert (profile.gemm.alpha, profile.gemm.beta) == (want.alpha, want.beta)
    assert r2s["attn"] == r2 and r2s["gemm"] == want_r2
