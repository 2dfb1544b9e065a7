"""The serving engine on an expert group of several ranks: one engine
process per rank, each holding its E/mo experts, in lock step, against
the reference engine on the same plain ("data", "model")
``jax.sharding.Mesh`` of forced host devices (f32, CPU).

The setup is the smoke qwen2-moe-a2.7b with weights from the reference's
``Model.init(PRNGKey(0))``, sharded by ``bridge.shard_experts``; FinDEP
on ``PAPER_A6000`` with ``DepClusterConfig(4, 2, 2)`` and an 8-sample
memory cap; 4 slots, max_context 64, seed 0; 3 requests with prompts
``range(2, 10 + i)``. On the (1, 2), (2, 2) and (1, 4) layouts every
rank gives the reference's greedy tokens; 11 teacher-forced decode
steps' logits (every slot) are within 1e-5 of the reference engine's;
and requests at temperature 0.8 give the same tokens on every rank.
``serve_moe --ep-size 2 --backend gloo`` (its own spawned ranks) gives
the tokens of the reference engine on a (1, 2) mesh given the same
weights (the port's seeded draw, converted).

Each layout's ranks are ``python -c`` workers with a ``file://`` store
in the test's tmp dir; each reference engine runs in a subprocess of its
own with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, all at
once."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import generator_for  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve_moe  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "qwen2-moe-a2.7b"
TOL = 1e-5
LAYOUTS = ((1, 2), (2, 2), (1, 4))
#: decode steps of the teacher-forced round (the first one unforced)
FORCED_STEPS = 11
#: serve_moe's run: one greedy request (a sampled one would draw other
#: tokens from JAX's PRNG than from the port's generator, and so change
#: the others' decode batch)
SERVE_ARGV = ["--device", "cpu", "--ep-size", "2", "--backend", "gloo",
              "--requests", "1", "--max-new", "6"]


def _flatten(tree, prefix="p"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


_COMMON = r"""
import sys
import numpy as np

d, name = sys.argv[1], sys.argv[2]
inputs = np.load(f"{d}/{name}.npz")
STEPS = int(inputs["steps"])


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


def forced(k):
    return np.random.RandomState(100 + k).randint(1, 1000, (4, 1))
"""

_GOLDEN = _COMMON + r"""
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.configs.base import DepClusterConfig
from repro.core.perf_model import PAPER_A6000
from repro.core.planner import FinDEPPlanner, PlannerConfig
from repro.runtime import Request, ServingEngine
from repro.runtime.sampler import sample
from repro.sched import FinDEPPolicy, make_policy

a, b = (int(x) for x in inputs["layout"])
mesh = jax.sharding.Mesh(np.array(jax.devices()[:a * b]).reshape(a, b),
                         ("data", "model"))
cfg = get_smoke_config("qwen2-moe-a2.7b")
serve_moe = bool(inputs["serve_moe"])
planner = (FinDEPPlanner(cfg, DepClusterConfig(8, 3, 5), PAPER_A6000,
                         PlannerConfig(mem_cap_samples=8)) if serve_moe
           else FinDEPPlanner(cfg, DepClusterConfig(4, 2, 2), PAPER_A6000,
                              PlannerConfig(mem_cap_samples=8)))
policy = (make_policy("findep", planner, static_seq_len=256) if serve_moe
          else FinDEPPolicy(planner))
eng = ServingEngine(cfg, params=tree(jnp.asarray), mesh=mesh, seed=0,
                    plan_policy=policy,
                    num_slots=int(inputs["slots"]),
                    max_context=int(inputs["max_context"]))
logits = []


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
    return nxt, caches, mstats


eng._decode_jit = decode
result = {}
if serve_moe:
    reqs = [Request(prompt=inputs["prompt"].tolist(),
                    max_new_tokens=int(inputs["max_new"]))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    result["tokens"] = np.array([r.output for r in reqs])
else:
    reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts()]
    for r in reqs:
        eng.submit(r)
    eng.run()
    result["tokens"] = np.array([r.output for r in reqs])
    for p in prompts():
        eng.submit(Request(prompt=p, max_new_tokens=STEPS + 1))
    first = len(logits)
    for k in range(STEPS):
        if k:
            eng.last_tokens = jnp.asarray(forced(k), jnp.int32)
        eng.step()
    eng.run()
    result["forced"] = np.stack(logits[first:first + STEPS])
np.savez(f"{d}/{name}-golden.npz", **result)
"""

_WORKER = _COMMON + r"""
import torch
from repro_torch.bridge import params_from_numpy, shard_experts
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import DepClusterConfig
from repro_torch.core.dep import DepGroups
from repro_torch.core.perf_model import PAPER_A6000
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig
from repro_torch.runtime import Request, ServingEngine
from repro_torch.sched import FinDEPPolicy

torch.set_num_threads(1)
rank = int(sys.argv[3])
a, b = (int(x) for x in inputs["layout"])
groups = DepGroups.from_file_store(f"{d}/{name}-store", rank, a, b, "gloo")
cfg = get_smoke_config("qwen2-moe-a2.7b")
policy = FinDEPPolicy(FinDEPPlanner(cfg, DepClusterConfig(4, 2, 2),
                                    PAPER_A6000,
                                    PlannerConfig(mem_cap_samples=8)))
params = shard_experts(params_from_numpy(tree(np.asarray)),
                       groups.expert_rank, b)
eng = ServingEngine(cfg, params=params, num_slots=4, max_context=64,
                    dtype=torch.float32, device="cpu", seed=0,
                    plan_policy=policy, ep_group=groups)
rows = {k: v.shape[0] for k, v in
        eng.params["layers"][0]["moe"]["experts"].items()}
result = {"rows": np.array(sorted(rows.values()))}
reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts()]
for r in reqs:
    eng.submit(r)
eng.run()
result["tokens"] = np.array([r.output for r in reqs])
for p in prompts():
    eng.submit(Request(prompt=p, max_new_tokens=STEPS + 1))
forced_logits = []
for k in range(STEPS):
    if k:
        eng.last_tokens.copy_(torch.from_numpy(forced(k)))
    eng.step()
    forced_logits.append(eng.last_logits.numpy().copy())
eng.run()
result["forced"] = np.stack(forced_logits)
sampled = [Request(prompt=p, max_new_tokens=6, temperature=0.8)
           for p in prompts()]
for r in sampled:
    eng.submit(r)
eng.run()
result["sampled"] = np.array([r.output for r in sampled])
result["headers"] = np.array(eng._lockstep.headers)
np.savez(f"{d}/{name}-rank{rank}.npz", **result)
torch.distributed.destroy_process_group()
"""


def _name(layout):
    return f"l{layout[0]}x{layout[1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_engine")
    ref = dict(_flatten(jax_build(jax_smoke(ARCH), dtype=jnp.float32).init(
        jax.random.PRNGKey(0))))
    for layout in LAYOUTS:
        np.savez(d / f"{_name(layout)}.npz", layout=np.array(layout),
                 steps=FORCED_STEPS, serve_moe=False, slots=4,
                 max_context=64, **ref)
    # serve_moe's ranks draw the one-rank model's weights from seed 0 and
    # keep their rows; the reference engine gets the whole draw
    args = serve_moe.build_parser().parse_args(SERVE_ARGV)
    cfg = get_smoke_config(ARCH)
    drawn = build_model(cfg, dtype=torch.float32, device="cpu").init(
        generator_for(torch.device("cpu"), 0))
    prompt = serve_moe.make_requests(cfg, args)[0].prompt
    np.savez(d / "serve.npz", layout=np.array((1, 2)), steps=0,
             serve_moe=True, slots=args.slots, max_context=args.max_context,
             prompt=np.array(prompt), max_new=args.max_new,
             **dict(_flatten(jax.tree_util.tree_map(
                 lambda t: t.numpy(), drawn))))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")

    def start(code, *argv, environ=env):
        return subprocess.Popen([sys.executable, "-c", code, str(d), *argv],
                                env=environ, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    procs = [start(_GOLDEN, "serve", environ=jenv)]
    procs += [start(_GOLDEN, _name(lay), environ=jenv) for lay in LAYOUTS]
    procs += [start(_WORKER, _name(lay), str(r)) for lay in LAYOUTS
              for r in range(lay[0] * lay[1])]
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_moe", *SERVE_ARGV],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=400)
        assert p.returncode == 0, out
        outs.append(out)
    line = next(s for s in outs[-1].splitlines()
                if s.startswith("first outputs:"))
    served = ast.literal_eval(line.split(":", 1)[1].strip())
    res = {}
    for lay in LAYOUTS:
        res[lay] = (dict(np.load(d / f"{_name(lay)}-golden.npz")),
                    [dict(np.load(d / f"{_name(lay)}-rank{r}.npz"))
                     for r in range(lay[0] * lay[1])])
    return res, served, outs[-1], dict(np.load(d / "serve-golden.npz"))


@pytest.mark.parametrize("layout", LAYOUTS, ids=_name)
def test_greedy_tokens_match_reference_on_every_rank(runs, layout):
    """Every rank, holding E/mo experts, gives the reference engine's
    greedy tokens on the same layout, after lock-step headers."""
    golden, shards = runs[0][layout]
    for s in shards:
        assert list(s["rows"]) == [4 // layout[1]] * 3
        assert np.array_equal(s["tokens"], golden["tokens"])
        assert int(s["headers"]) > 0


@pytest.mark.parametrize("layout", LAYOUTS, ids=_name)
def test_teacher_forced_logits_match_reference(runs, layout):
    """11 decode steps fed the same tokens: every rank's logits, every
    slot's row included, within 1e-5 of the reference engine's."""
    golden, shards = runs[0][layout]
    want = golden["forced"]
    assert want.shape[0] == FORCED_STEPS
    for s in shards:
        assert s["forced"].shape == want.shape
        assert np.abs(s["forced"] - want).max() < TOL


@pytest.mark.parametrize("layout", LAYOUTS, ids=_name)
def test_sampled_tokens_agree_across_ranks(runs, layout):
    """At temperature 0.8 every rank holds rank 0's sampled tokens (rank
    0's draw is broadcast after the token readback)."""
    _, shards = runs[0][layout]
    for s in shards[1:]:
        assert np.array_equal(s["sampled"], shards[0]["sampled"])
    assert shards[0]["sampled"].shape == (3, 6)


def test_serve_moe_on_two_ranks_matches_reference(runs):
    """``serve_moe --ep-size 2 --backend gloo``: two spawned ranks serve
    the tokens of the reference engine on a (1, 2) mesh given the same
    weights, and the launcher found both ranks' tokens equal."""
    _, served, out, golden = runs
    assert "all 2 ranks served the same tokens" in out
    assert "1 data x 2 expert over gloo, 2 experts a rank" in out
    assert served == golden["tokens"].tolist()
