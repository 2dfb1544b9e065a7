"""Calibration on an expert group of several ranks (f32, CPU, gloo): the
engine's ``calibrate=True``, ``recalibrate_max_age_s`` and drift
re-calibration with one engine process per rank, in lock step.

Every setup serves the smoke qwen2-moe-a2.7b under FinDEP
(``DepClusterConfig(4, 2, 2)``, an 8-sample memory cap) with 4 slots and
max_context 64, seed 0; torch runs one intra-op thread a process.

  (a) stub: the reference engine on a (1, 2) plain ``jax.sharding.Mesh``
      of forced host devices and the port's two ranks, both on
      ``PAPER_A6000`` with a fresh stored profile, serve 3 greedy
      requests; after 3 steps a re-calibration whose ``calibrate_fn``
      returns ``STUB`` (``PAPER_A6000`` with every intercept 0, which
      moves the plans to r1 = 3) is forced (rank 0) and drained (every
      rank). The planner hardware, the decode programs, the tokens and
      every decode step's logits (1e-5) equal the reference's.
  (b) live: a real fast calibration at (1, 2) and (2, 2), due at the
      first poll of an empty store, runs while requests are served until
      rank 0's job ends. Every torch.distributed call of every rank is
      recorded with its thread.
  (c) ``calibrate=True`` at construction on two ranks; (d) a drift
      episode under a profile 1e5 too fast; (f) a job closed after two
      of its comm samples, on both ranks.
  (e) ``serve_moe --ep-size 2 --backend gloo --calibrate
      --drift-threshold 0.5``.

Each rank is a ``python -c`` worker with a ``file://`` store in the
test's tmp dir; the reference engine runs in a subprocess of its own with
``XLA_FLAGS=--xla_force_host_platform_device_count=2``; (a) and (b) start
at once, then (c)-(f), each process under ``TIMEOUT_S``. The protocol
itself (rank 0's headers, a comm sweep retried on rank 0's fit, a
follower's view) is also driven in this process through a stand-in lock
step."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import DepClusterConfig  # noqa: E402
from repro_torch.core.perf_model import PAPER_A6000  # noqa: E402
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig  # noqa: E402
from repro_torch.profiling import (CalibStep, MicrobenchSamples,  # noqa: E402
                                   PeriodicRecalibrator, ProfileKey,
                                   ProfileStore)
from repro_torch.profiling.microbench import LocalCalibration  # noqa: E402
from repro_torch.profiling.refresh import IDLE, JOB_DONE  # noqa: E402
from repro_torch.sched import FinDEPPolicy, PlanCache  # noqa: E402
from test_torch_sharded_engine import _flatten  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "qwen2-moe-a2.7b"
TOL = 1e-5
LIVE = ((1, 2), (2, 2))
#: each subprocess's limit
TIMEOUT_S = 400
#: the step after which (a) forces its re-calibration
FORCE_AT = 3

_COMMON = r"""
import json, sys, threading, time
import numpy as np

d, name = sys.argv[1], sys.argv[2]
inputs = np.load(f"{d}/params.npz")


def tree(f):
    out = {}
    for key in inputs.files:
        if key.startswith("p/"):
            node = out
            *path, leaf = key.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = f(inputs[key])
    out["layers"] = [out["layers"][str(i)]
                     for i in range(len(out["layers"]))]
    return out


def prompts():
    return [list(range(2, 10 + i)) for i in range(3)]


def stub_profile(perf):
    a = perf.PAPER_A6000
    return perf.HardwareProfile(
        "stub", gemm=perf.AlphaBeta(0.0, a.gemm.beta),
        attn=perf.AlphaBeta(0.0, a.attn.beta),
        comm=perf.AlphaBeta(0.0, a.comm.beta))


def stub_result(mb, hw):
    kinds = ("gemm", "attn", "comm", "decode")
    return mb.CalibrationResult(
        profile=hw, fit_r2={k: 1.0 for k in kinds},
        samples={k: mb.MicrobenchSamples(k, [1.0, 2.0], [1.0, 2.0])
                 for k in kinds}, wall_s=0.0)


def program(p):
    g = p.graph
    return [g.r1, g.r2, g.order, g.m_e]
"""

_GOLDEN = _COMMON + r"""
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.configs.base import DepClusterConfig
from repro.core import perf_model as perf
from repro.core.planner import FinDEPPlanner, PlannerConfig
from repro.profiling import microbench as mb
from repro.profiling import ProfileStore
from repro.runtime import Request, ServingEngine
from repro.runtime.sampler import sample
from repro.sched import FinDEPPolicy

mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                         ("data", "model"))
cfg = get_smoke_config("qwen2-moe-a2.7b")
policy = FinDEPPolicy(FinDEPPlanner(cfg, DepClusterConfig(4, 2, 2),
                                    perf.PAPER_A6000,
                                    PlannerConfig(mem_cap_samples=8)))
eng = ServingEngine(cfg, params=tree(jnp.asarray), mesh=mesh, seed=0,
                    plan_policy=policy, num_slots=4, max_context=64,
                    recalibrate_max_age_s=3600.0,
                    profile_store=f"{d}/golden-store")
rc = eng.recalibrator
rc.store.put_calibration(stub_result(mb, perf.PAPER_A6000), rc.key)
stub = stub_result(mb, stub_profile(perf))
rc.calibrate_fn = lambda: stub
logits, programs = [], []


def step_logits(params, tokens, caches, temps, top_ks, key, lengths,
                block_tables=None, plan=None, use_topk=False, placement=None,
                cap_scale=1.0, collect_stats=False):
    out, caches = eng.model.decode_step(
        params, tokens, caches, plan=plan, lengths=lengths,
        block_tables=block_tables, placement=placement,
        capacity_scale=cap_scale)
    nxt = sample(key, out[:, -1], temps, top_ks if use_topk else 0)
    return nxt[:, None], caches, None, out


# the engine's decode step, returning its logits too (the same jit keys)
inner = jax.jit(step_logits, static_argnames=(
    "plan", "use_topk", "placement", "cap_scale", "collect_stats"))


def decode(*args, **kw):
    nxt, caches, mstats, out = inner(*args, **kw)
    logits.append(np.asarray(out))
    programs.append(program(kw["plan"]))
    return nxt, caches, mstats


eng._decode_jit = decode
reqs = [Request(prompt=p, max_new_tokens=10) for p in prompts()]
for r in reqs:
    eng.submit(r)
for _ in range(int(inputs["force_at"])):
    eng.step()
rc.maybe_recalibrate(force=True)
rc.drain()
eng.run()
np.savez(f"{d}/golden.npz", tokens=np.array([r.output for r in reqs]),
         logits=np.stack(logits), programs=np.array(programs, dtype=object),
         hardware=json.dumps(policy.planner.hardware.as_dict()),
         recalibrations=rc.recalibrations)
"""

_PORT = _COMMON + r"""
import torch
import torch.distributed as dist

# every collective of this process, with whether the main thread issued it
CALLS = []
for _n in ("all_to_all_single", "broadcast", "broadcast_object_list",
           "all_reduce", "all_gather", "all_gather_object",
           "all_gather_into_tensor", "reduce_scatter_tensor", "barrier",
           "send", "recv", "gather", "scatter"):
    def _wrap(*a, _fn=getattr(dist, _n), _name=_n, **kw):
        CALLS.append((_name, threading.current_thread().name))
        return _fn(*a, **kw)
    setattr(dist, _n, _wrap)

from repro_torch.bridge import params_from_numpy, shard_experts
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import DepClusterConfig
from repro_torch.core import perf_model as perf
from repro_torch.core.dep import DepGroups
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig
from repro_torch.profiling import microbench as mb
from repro_torch.profiling import ProfileKey, ProfileStore
from repro_torch.runtime import Request, ServingEngine
from repro_torch.sched import FinDEPPolicy

torch.set_num_threads(1)
rank = int(sys.argv[3])
a, b = (int(x) for x in sys.argv[4:6])
groups = DepGroups.from_file_store(f"{d}/{name}-group", rank, a, b, "gloo")
cfg = get_smoke_config("qwen2-moe-a2.7b")
PUTS = []
_put = ProfileStore.put_calibration


def counted_put(self, *args, **kw):
    PUTS.append(threading.current_thread().name)
    return _put(self, *args, **kw)


ProfileStore.put_calibration = counted_put


def engine(hw=perf.PAPER_A6000, **kw):
    policy = FinDEPPolicy(FinDEPPlanner(cfg, DepClusterConfig(4, 2, 2), hw,
                                        PlannerConfig(mem_cap_samples=8)))
    kw.setdefault("profile", hw)
    return ServingEngine(cfg, num_slots=4, max_context=64,
                         dtype=torch.float32, device="cpu", seed=0,
                         plan_policy=policy, ep_group=groups, **kw)


def decode_programs(eng):
    return [program(p) for ph, p in eng.stats.programs if ph == "decode"]


def stepwise(eng, reqs, after=None):
    # eng.run() a step at a time; the logits of every decode step
    for r in reqs:
        eng.submit(r)
    logits = []
    while True:
        n = eng.stats.steps
        busy = eng.step()
        if eng.stats.steps > n:
            logits.append(eng.last_logits.numpy().copy())
        if after is not None:
            after()
        if not busy and not eng.waiting:
            return logits


out = {}
"""

_WORKER_A = _PORT + r"""
params = shard_experts(params_from_numpy(tree(np.asarray)),
                       groups.expert_rank, b)
store = f"{d}/a-store"
eng = engine(params=params, recalibrate_max_age_s=3600.0,
             profile_store=store)
rc = eng.recalibrator
if rank == 0:
    # a fresh profile: the first poll finds nothing due
    rc.store.put_calibration(stub_result(mb, perf.PAPER_A6000), rc.key)
stub = stub_result(mb, stub_profile(perf))
rc.calibrate_fn = lambda: stub
reqs = [Request(prompt=p, max_new_tokens=10) for p in prompts()]
for r in reqs:
    eng.submit(r)
logits = []
for _ in range(int(inputs["force_at"])):
    eng.step()
    logits.append(eng.last_logits.numpy().copy())
rc.maybe_recalibrate(force=True)
rc.drain()
logits += stepwise(eng, [])
out.update(tokens=[r.output for r in reqs], logits=np.stack(logits).tolist(),
           programs=decode_programs(eng),
           hardware=eng.plan_policy.planner.hardware.as_dict(),
           recalibrations=rc.recalibrations, joined=rc.joined)
eng.close()
"""

_WORKER_B = _PORT + r"""
eng = engine(recalibrate_max_age_s=3600.0, profile_store=f"{d}/{name}-store")
rc = eng.recalibrator
ls = eng._lockstep
local_window, sample_steps, per_step = [], [], []
local_fn, sample_fn = rc.local_fn, rc.sample_fn


def local():
    local_window.append(eng.stats.steps)
    try:
        return local_fn()
    finally:
        local_window.append(eng.stats.steps)


def sample(size):
    sample_steps.append(eng.stats.steps)
    return sample_fn(size)


rc.local_fn, rc.sample_fn = local, sample
counts = {"call": 0, "decode": 0}
follow_call, follow_decode = ls.follow_call, ls.follow_decode


def counted_call(*a, **kw):
    counts["call"] += 1
    return follow_call(*a, **kw)


def counted_decode(*a, **kw):
    counts["decode"] += 1
    got = follow_decode(*a, **kw)
    counts["calib"] = list(got[2])
    return got


ls.follow_call, ls.follow_decode = counted_call, counted_decode
reqs, k = [], 0
while True:
    # every rank tops up with the same requests at the same steps
    while len(eng.waiting) + sum(s is not None for s in eng.slots) < 4:
        reqs.append(Request(prompt=list(range(2, 10 + k % 5)),
                            max_new_tokens=12))
        eng.submit(reqs[-1])
        k += 1
    before = (ls.headers, counts["call"], counts["decode"])
    counts["calib"] = None
    eng.step()
    per_step.append([ls.headers - before[0], counts["call"] - before[1],
                     counts["decode"] - before[2], counts["calib"]])
    # rank 0's view: its job has ended (the test's own header)
    if ls.follow([rc.joined])[0] or eng.stats.steps > 3000:
        break
eng.run()
rc.drain()
res = rc.last_result
out.update(tokens=[r.output for r in reqs], joined=rc.joined,
           recalibrations=rc.recalibrations, local_window=local_window,
           sample_steps=sample_steps, per_step=per_step,
           sample_log=rc.sample_log, puts=PUTS,
           comm_xs=res.samples["comm"].xs, comm_proxy=res.comm_is_proxy,
           fit_r2=res.fit_r2, retries=res.retries, sizes=list(rc.sizes))
if rank == 0:
    back = ProfileStore(f"{d}/{name}-store").get_for_key(rc.key)
    out["loads_back"] = (back.profile == res.profile
                         and back.profile.as_dict() == res.profile.as_dict()
                         and back.fit_r2 == res.fit_r2
                         and back.samples == {k: v.as_xt() for k, v in
                                              res.samples.items()}
                         and not back.comm_proxy)
eng.close()
"""

_WORKER_C = _PORT + r"""
# (c) calibrate=True at construction
eng = engine(calibrate=True, profile_store=f"{d}/c-store", profile=None)
out["c"] = dict(hardware=eng.plan_policy.planner.hardware.as_dict(),
                own=eng.calibration.profile.as_dict(),
                comm_proxy=eng.calibration.comm_is_proxy, puts=len(PUTS))
if rank == 0:
    back = ProfileStore(f"{d}/c-store").get_for_key(
        ProfileKey.for_host(groups, torch.float32, "cpu"))
    out["c"]["stored"] = back.profile.as_dict()
eng.close()

# (d) a drift episode under a profile 1e5 too fast
eng = engine(hw=stub_profile(perf).scaled(1e-5), drift_threshold=0.5,
             drift_min_samples=1)
drain = eng.drift.refresher.drain if rank == 0 else None
reqs = [Request(prompt=p, max_new_tokens=16) for p in prompts()]
stepwise(eng, reqs, after=drain)
out["d"] = dict(programs=decode_programs(eng),
                hints=[len(p.hints or ()) for ph, p in eng.stats.programs
                       if ph == "prefill"],
                events=eng.drift.stats.drift_events,
                refreshes=eng.plan_cache.stats.refreshes,
                tokens=[r.output for r in reqs])
eng.close()

# (f) a job closed after two of its comm samples
eng = engine(recalibrate_max_age_s=3600.0, profile_store=f"{d}/f-store")
rc = eng.recalibrator
k = 0
while len(rc.sample_log) < 2 and eng.stats.steps < 3000:
    while len(eng.waiting) + sum(s is not None for s in eng.slots) < 4:
        eng.submit(Request(prompt=list(range(2, 10 + k % 5)),
                           max_new_tokens=12))
        k += 1
    eng.step()
eng.close()
t = time.perf_counter()
dist.barrier()
out["f"] = dict(samples=len(rc.sample_log), busy=rc.busy,
                recalibrations=rc.recalibrations, joined=rc.joined,
                barrier_s=time.perf_counter() - t,
                stored=ProfileStore(f"{d}/f-store").names())
"""

_END = r"""
out["calls"] = CALLS
dist.destroy_process_group()
with open(f"{d}/{name}-rank{rank}.json", "w") as f:
    json.dump(out, f)
"""


def _start(code, d, *argv, env):
    return subprocess.Popen([sys.executable, "-c", code, str(d), *argv],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wide_calibration")
    ref = dict(_flatten(jax_build(jax_smoke(ARCH), dtype=jnp.float32).init(
        jax.random.PRNGKey(0))))
    np.savez(d / "params.npz", force_at=FORCE_AT, **ref)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2")
    store = d / "serve-store"
    t0 = time.perf_counter()
    outs = {}

    def wait(procs):
        for key, p in procs.items():
            out, _ = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, (key, out)
            outs[key] = out

    # two waves of at most nine processes, so that the host's other
    # tests keep their cores
    procs = {"golden": _start(_GOLDEN, d, "golden", env=jenv)}
    for r in range(2):
        procs[("a", r)] = _start(_WORKER_A + _END, d, "a", str(r), "1", "2",
                                 env=env)
    for lay in LIVE:
        name = f"b{lay[0]}x{lay[1]}"
        for r in range(lay[0] * lay[1]):
            procs[(name, r)] = _start(_WORKER_B + _END, d, name, str(r),
                                      *map(str, lay), env=env)
    wait(procs)
    procs = {("c", r): _start(_WORKER_C + _END, d, "c", str(r), "1", "2",
                              env=env) for r in range(2)}
    procs["serve"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_moe",
         "--device", "cpu", "--ep-size", "2", "--backend", "gloo",
         "--calibrate", "--drift-threshold", "0.5", "--requests", "4",
         "--max-new", "8", "--profile-store", str(store)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    wait(procs)

    def load(name, n):
        return [json.loads((d / f"{name}-rank{r}.json").read_text())
                for r in range(n)]
    return dict(golden=dict(np.load(d / "golden.npz", allow_pickle=True)),
                a=load("a", 2), c=load("c", 2),
                b={lay: load(f"b{lay[0]}x{lay[1]}", lay[0] * lay[1])
                   for lay in LIVE},
                serve=outs["serve"], store=store,
                wall_s=time.perf_counter() - t0)


def test_stub_recalibration_matches_reference_plans(runs):
    """(a) A re-calibration forced on rank 0 and drained on every rank
    after 3 steps: rank 0's planner holds the stub's profile, as the
    reference's does; the decode programs (r1, r2, order, m_e) of every
    rank are the reference's, in order, and move to r1 = 3 after the
    re-calibration. Rank 0 re-calibrated, rank 1 only took part."""
    golden, ranks = runs["golden"], runs["a"]
    want = [list(p) for p in golden["programs"]]
    assert ranks[0]["hardware"] == json.loads(str(golden["hardware"]))
    assert ranks[0]["hardware"]["gemm"]["alpha"] == 0.0
    assert int(golden["recalibrations"]) == 1
    for r, s in enumerate(ranks):
        assert s["programs"] == want
        assert s["joined"] == 1 and s["recalibrations"] == (r == 0)
    assert want[FORCE_AT - 1][0] == 1 and want[FORCE_AT][0] == 3


def test_stub_recalibration_matches_reference_tokens(runs):
    """(a) The same greedy tokens on every rank as the reference's, and
    every decode step's logits (every slot) within 1e-5 of its."""
    golden, ranks = runs["golden"], runs["a"]
    for s in ranks:
        assert s["tokens"] == golden["tokens"].tolist()
        got = np.array(s["logits"])
        assert got.shape == golden["logits"].shape
        assert np.abs(got - golden["logits"]).max() < TOL


def _name(lay):
    return f"{lay[0]}x{lay[1]}"


@pytest.mark.parametrize("layout", LIVE, ids=_name)
def test_live_calibration_measures_the_wire(runs, layout):
    """(b) Every rank's comm fit comes from a live all_to_all
    (``comm_is_proxy`` False) over the same sizes on every rank (the
    fast sweep's), and only rank 0 re-calibrated."""
    ranks = runs["b"][layout]
    for r, s in enumerate(ranks):
        assert not s["comm_proxy"] and s["joined"] == 1
        assert s["recalibrations"] == (r == 0)
        assert s["comm_xs"] == ranks[0]["comm_xs"]
        assert len(s["comm_xs"]) == len(s["sizes"]) == 6
        assert set(s["fit_r2"]) == {"gemm", "attn", "comm", "decode"}
        # retries of the comm sweep are rank 0's: every rank took them
        assert s["retries"]["comm"] == ranks[0]["retries"]["comm"]


@pytest.mark.parametrize("layout", LIVE, ids=_name)
def test_live_calibration_paces_samples_by_steps(runs, layout):
    """(b) At least one step is served while a rank's local sweeps run
    on its worker, and every comm sample runs at a step end of its own,
    after the local sweeps, on every rank at the same step."""
    ranks = runs["b"][layout]
    for s in ranks:
        start, end = s["local_window"]
        assert end - start >= 1
        steps = s["sample_steps"]
        assert len(steps) == len(set(steps)) == len(s["sample_log"])
        assert steps == sorted(steps) and steps[0] >= start
        assert steps == ranks[0]["sample_steps"]


@pytest.mark.parametrize("layout", LIVE, ids=_name)
def test_live_calibration_rank0_alone_stores(runs, layout):
    """(b) Rank 0 alone writes the store (from its worker), once, and the
    stored profile loads back bit for bit."""
    ranks = runs["b"][layout]
    assert len(ranks[0]["puts"]) == 1
    assert ranks[0]["puts"][0].startswith("plan-refresh")
    assert all(s["puts"] == [] for s in ranks[1:])
    assert ranks[0]["loads_back"]


@pytest.mark.parametrize("layout", LIVE, ids=_name)
def test_live_calibration_keeps_collectives_on_main_thread(runs, layout):
    """(b) Every torch.distributed call of every rank, the calibration's
    all_to_all samples included, came from the main thread, and the
    ranks served the same tokens."""
    ranks = runs["b"][layout]
    for s in ranks:
        names = {n for n, _ in s["calls"]}
        assert "all_to_all_single" in names and "broadcast" in names
        assert {t for _, t in s["calls"]} == {"MainThread"}
        assert s["tokens"] == ranks[0]["tokens"]


@pytest.mark.parametrize("layout", LIVE, ids=_name)
def test_live_calibration_adds_no_header(runs, layout):
    """(b) Every step that decodes issues three headers besides its
    prefill calls' (admission, the decode call, the tokens), whether its
    calibration field starts a job, runs a sample or nothing."""
    for s in runs["b"][layout]:
        fields = set()
        for headers, calls, decodes, calib in s["per_step"]:
            if decodes:
                assert headers - calls == 3
                fields.add(tuple(calib) if calib[1] < 0 else "sample")
        assert {(0, -1, 0), (1, -1, 0), "sample", (0, JOB_DONE, 0)} <= fields


def test_calibrate_at_construction_follows_rank0(runs):
    """(c) ``calibrate=True`` on two ranks: each measured its own fit (the
    comm sweep live), every rank's planner holds rank 0's, and rank 0
    alone stored it."""
    ranks = [s["c"] for s in runs["c"]]
    want = ranks[0]["own"]
    assert ranks[0]["stored"] == want
    for r, s in enumerate(ranks):
        assert s["hardware"] == want and not s["comm_proxy"]
        assert s["puts"] == (r == 0)


def test_drift_episode_reaches_both_ranks(runs):
    """(d) Under a profile 1e5 too fast, drift fires on rank 0 and its
    re-solves land; both ranks walk the same program at every decode
    call, and rank 0's re-solved program shows from the same call on
    both. The prefill's program (r2 = 64) has more priority hints than a
    header's first broadcast holds: the rest followed in a second."""
    ranks = [s["d"] for s in runs["c"]]
    assert max(ranks[0]["hints"]) > 511 and ranks[1]["hints"] == \
        ranks[0]["hints"]
    assert ranks[0]["events"] >= 1 and ranks[0]["refreshes"] >= 1
    progs = ranks[0]["programs"]
    assert ranks[1]["programs"] == progs
    assert any(p != progs[0] for p in progs)
    assert ranks[1]["tokens"] == ranks[0]["tokens"]


def test_close_mid_job_leaves_no_rank_waiting(runs):
    """(f) Closed after two comm samples, every rank abandons the job at
    the same step end: none waits in a sample (a barrier after the close
    passes at once), nothing was fitted or stored."""
    for s in runs["c"]:
        f = s["f"]
        assert f["samples"] == 2 and not f["busy"]
        assert f["recalibrations"] == 0 == f["joined"]
        assert f["barrier_s"] < 30.0 and f["stored"] == []


def test_serve_moe_calibrates_on_two_ranks(runs):
    """(e) ``serve_moe --ep-size 2 --backend gloo --calibrate
    --drift-threshold 0.5`` runs to its report: rank 0's live fit (no
    proxy) is stored once, and both ranks served the same tokens."""
    out = runs["serve"]
    assert "calibrated 'cpu_1x2_float32'" in out and "comm=proxy" not in out
    assert "all 2 ranks served the same tokens" in out
    assert "drift:" in out and "served 4/4 requests" in out
    assert ProfileStore(runs["store"]).names() == ["cpu_1x2_float32"]


class _LockStep:
    """A stand-in for an active ``LockStep`` of one rank's role."""

    active = True

    def __init__(self, lead: bool):
        self.lead = lead

    def follow(self, values):
        return list(values)


def _recalibrator(tmp_path, lead, samples):
    cfg = get_smoke_config(ARCH)
    cache = PlanCache(FinDEPPolicy(FinDEPPlanner(
        cfg, DepClusterConfig(4, 2, 2), PAPER_A6000,
        PlannerConfig(mem_cap_samples=8))))
    cache.get("prefill", 16, 3)
    local = LocalCalibration(
        {k: MicrobenchSamples(k, [1.0, 2.0, 3.0], [1.0, 2.0, 3.0])
         for k in ("gemm", "attn", "decode")}, {"gemm": 0, "attn": 0,
                                                 "decode": 0}, 0.5)
    return PeriodicRecalibrator(
        cache, ProfileStore(tmp_path / ("lead" if lead else "follower")),
        key=ProfileKey("cpu", (1, 2), "float32"), device="cpu",
        lockstep=_LockStep(lead), local_fn=lambda: local,
        sample_fn=lambda size: (float(size), next(samples))), cache


def test_group_job_protocol_and_retry(tmp_path):
    """The protocol on each role, driven by rank 0's fields: rank 0 polls
    (an empty store is due), starts the job at its next header, issues
    the fast CPU sweep's six samples once the local sweeps are done,
    retries the sweep when its fit misses ``MIN_R2`` (a scrambled first
    sweep), then ends the job and stores the better sweep's fit; the
    follower decides nothing, takes the same samples, fits its own
    result and stores nothing."""
    def times(n_sweeps):
        bad = [6.0, 1.0, 5.0, 2.0, 4.0, 3.0]
        good = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0]
        return iter((bad + good)[:6 * n_sweeps])
    lead, cache = _recalibrator(tmp_path, True, times(2))
    follower, _ = _recalibrator(tmp_path, False, times(2))
    assert lead.sizes == tuple(2 ** i for i in range(20, 26))
    assert follower.maybe_recalibrate(force=True) is False
    assert follower.next_step() == IDLE
    assert lead.maybe_recalibrate() is True and lead.busy
    assert lead.maybe_recalibrate(force=True) is False
    fields = []
    while True:
        step = lead.next_step(wait=True)
        if step == IDLE:
            break
        fields.append(step)
        for rc in (lead, follower):
            rc.at_step(step)
    sizes = list(lead.sizes) * 2
    assert fields == ([CalibStep(start=1)]
                      + [CalibStep(sample=i, size=z)
                         for i, z in enumerate(sizes)]
                      + [CalibStep(sample=JOB_DONE)])
    lead.drain()
    assert lead.recalibrations == 1 and follower.recalibrations == 0
    assert lead.joined == follower.joined == 1 and not lead.busy
    for rc in (lead, follower):
        res = rc.last_result
        assert res.retries["comm"] == 1
        assert res.samples["comm"].ts == [1.0, 2.0, 4.0, 8.0, 16.0, 32.0]
        assert res.wall_s == 0.5 + sum(e["wall_s"] for e in rc.sample_log)
    stored = ProfileStore(tmp_path / "lead").get_for_key(lead.key)
    assert stored.profile == lead.last_result.profile
    assert ProfileStore(tmp_path / "follower").names() == []
    assert cache.stats.refreshes >= 1
    lead.close()
    follower.close()
