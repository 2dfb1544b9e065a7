"""The model on an expert group of several ranks, each rank holding its
own experts (``Model.init(expert_shard=)``, ``bridge.shard_experts``),
against the reference on a forced 4-device host mesh, on the smoke
qwen2-moe-a2.7b (f32, CPU, 4 experts, capacity factor 1.25: some
assignments drop, so each rank's capacity is checked too):

* the dispatch-mode repair: ``moe_apply_dep`` takes sequence mode from
  the GLOBAL length. At S = 4 and 8 over 4 expert ranks each rank holds
  1 or 2 positions, and the reference runs sequence mode; the rule the
  port had (``seq_mode`` of the local length) takes replicated mode
  there and sums four ranks' different tokens, which the control case
  shows missing the reference;
* ``Model.prefill`` (with its MoE stats) and ``decode_step`` on the
  (1, 4) and (2, 2) layouts against the reference ``Model`` under
  ``ExecutionContext(mesh=..., moe_impl="dep")`` at 1e-5, including a
  batch the data axis does not divide (every data shard holds it whole);
* the serving engine on (2, 2) before and after a cross-rank placement
  (``rebalance_now(placement=)``) against the reference engine after
  ``_apply_placement`` of the same ``Placement``: the tokens, each
  rank's expert rows (the reference's permuted stack, in place) and the
  hot expert's weights fetched from its owner;
* ``Model.init`` shards equal the one-rank model's rows, and the
  refusals of what the sharded engine does not carry across ranks.

The reference runs in one subprocess and the four ranks in four more
(``python -c`` workers, a ``file://`` store in the test's tmp dir), all
at once; each rank writes what it computed to a file."""
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
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import generator_for  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.dep import DepGroups  # noqa: E402
from repro_torch.launch import serve_moe  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "qwen2-moe-a2.7b"
TOL = 1e-5
#: global sequence lengths of the mode-repair cases at mo = 4 (1 and 2
#: positions a rank)
MODE_LENGTHS = (4, 8)
#: the model cases: (name, layout (data, expert), batch, prefill length)
MODEL_CASES = (("e4", (1, 4), 2, 8), ("d2e2", (2, 2), 2, 8),
               ("d2e2-b3", (2, 2), 3, 8))
DECODE_STEPS = 3
#: the cross-rank placement: rank 0 owns experts 1 and 2, rank 1 experts
#: 0 and 3 (physical rows 2, 0, 1, 3), expert 3 replicated on every rank
ASSIGNMENT, HOT = (1, 0, 0, 1), (3,)
#: prompt lengths of the engine's requests before and after it
REQS_BEFORE, REQS_AFTER = (6, 9, 12), (5, 14, 8)
NEW_TOKENS = 4


def _flatten(tree, prefix):
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

d = sys.argv[1]
inputs = np.load(f"{d}/inputs.npz")


def tree(prefix, f):
    out = {}
    for key in inputs.files:
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = f(inputs[key])
    if "layers" in out:
        out["layers"] = [out["layers"][str(i)]
                         for i in range(len(out["layers"]))]
    return out


MODEL_CASES = [(n, (int(a), int(b)), int(B), int(S))
               for n, a, b, B, S in inputs["model_cases"]]
STEPS = int(inputs["steps"])
ASSIGNMENT = tuple(int(a) for a in inputs["assignment"])
HOT = tuple(int(a) for a in inputs["hot"])
PROMPTS = [[inputs[f"prompt-{w}-{i}"].tolist()
            for i in range(int(inputs[f"prompts-{w}"]))]
           for w in ("before", "after")]
NEW = int(inputs["new_tokens"])
"""

_GOLDEN = _COMMON + r"""
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.configs.base import DepClusterConfig
from repro.core import dep
from repro.core.perf_model import PAPER_A6000
from repro.core.planner import FinDEPPlanner, PlannerConfig
from repro.models import build_model
from repro.models.transformer import ExecutionContext
from repro.placement import Placement
from repro.runtime import Request, ServingEngine
from repro.sched import FinDEPPolicy


def mesh_of(a, b):
    return jax.sharding.Mesh(np.array(jax.devices()[:a * b]).reshape(a, b),
                             ("data", "model"))


cfg = get_smoke_config("qwen2-moe-a2.7b")
out = {}
m4 = mesh_of(1, 4)
layer = tree("layer", jnp.asarray)
for S in (4, 8):
    x = jnp.asarray(inputs[f"x{S}"])
    with m4:
        y, _ = jax.jit(lambda p, x: dep.moe_apply_dep(
            p, x, cfg.moe, ExecutionContext(mesh=m4, moe_impl="dep"),
            4))(layer, x)
    out[f"mode-{S}"] = y
params = tree("model", jnp.asarray)
for name, (a, b), B, S in MODEL_CASES:
    mesh = mesh_of(a, b)
    model = build_model(cfg, ctx=ExecutionContext(mesh=mesh, moe_impl="dep"),
                        dtype=jnp.float32)
    toks = jnp.asarray(inputs[f"tokens-{name}"])
    with mesh:
        logits, caches, st = jax.jit(lambda p, t: model.prefill(
            p, t, seq_budget=S + STEPS, return_moe_stats=True))(params, toks)
        out[f"{name}-prefill"] = logits
        out[f"{name}-load"], out[f"{name}-dropped"] = st.load, st.dropped
        step = jax.jit(lambda p, t, c: model.decode_step(p, t, c))
        for k in range(STEPS):
            logits, caches = step(params, jnp.asarray(
                inputs[f"decode-{name}"][k]), caches)
            out[f"{name}-decode{k}"] = logits

# the engine on (2, 2), before and after the placement
mesh = mesh_of(2, 2)
policy = FinDEPPolicy(FinDEPPlanner(cfg, DepClusterConfig(4, 2, 2),
                                    PAPER_A6000,
                                    PlannerConfig(mem_cap_samples=8)))
eng = ServingEngine(cfg, params=params, num_slots=4, max_context=64,
                    mesh=mesh, seed=0, plan_policy=policy,
                    replicate_hot_k=1, rebalance_threshold=1e9)
for w, prompts in enumerate(PROMPTS):
    if w:
        eng._apply_placement(Placement(4, 2, ASSIGNMENT, HOT, epoch=1))
        for k, v in eng.params["layers"][1]["moe"]["experts"].items():
            out[f"placed-{k}"] = v
    reqs = [Request(prompt=p, max_new_tokens=NEW) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    out[f"tokens-{w}"] = np.array([r.output for r in reqs])
out["engine-dropped"] = eng.stats.dropped_tokens
np.savez(f"{d}/golden.npz", **{k: np.asarray(v) for k, v in out.items()})
"""

_WORKER = _COMMON + r"""
import torch
import torch.distributed as dist
from repro_torch.bridge import params_from_numpy, shard_experts
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import DepClusterConfig
from repro_torch.core import dep
from repro_torch.core.perf_model import PAPER_A6000
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig
from repro_torch.models import ExecutionContext, build_model
from repro_torch.placement import Placement
from repro_torch.runtime import Request, ServingEngine
from repro_torch.sched import FinDEPPolicy

torch.set_num_threads(1)
rank = int(sys.argv[2])
groups = {(1, 4): dep.DepGroups.from_file_store(f"{d}/store", rank, 1, 4,
                                                "gloo")}
groups[(2, 2)] = dep.DepGroups.build(2, 2)
cfg = get_smoke_config("qwen2-moe-a2.7b")
out = {}

# the mode repair: rank m holds positions [m·S/4, (m+1)·S/4) of a batch of 2
g = groups[(1, 4)]
layer = tree("layer", torch.from_numpy)
layer["experts"] = {k: v[rank:rank + 1] for k, v in layer["experts"].items()}
for S in (4, 8):
    x = torch.from_numpy(inputs[f"x{S}"])
    x_loc = dep.split_tokens(x, g, sequence=True, batch_sharded=False)
    for rule, seq in (("global", dep.seq_mode(S, 4)),
                      ("local", dep.seq_mode(x_loc.shape[1], 4))):
        y, _ = dep.moe_apply_dep(layer, x_loc, cfg.moe, g, 4,
                                 sequence=seq, batch_sharded=False)
        out[f"mode-{S}-{rule}"] = y

full = params_from_numpy(tree("model", np.asarray))
for name, layout, B, S in MODEL_CASES:
    g = groups[layout]
    model = build_model(cfg, ctx=ExecutionContext(moe_impl="dep", groups=g),
                        dtype=torch.float32, device="cpu")
    params = shard_experts(full, g.expert_rank, g.expert_size)
    toks = torch.from_numpy(inputs[f"tokens-{name}"]).long()
    logits, caches, st = model.prefill(params, toks, seq_budget=S + STEPS,
                                       return_moe_stats=True)
    out[f"{name}-prefill"] = logits
    out[f"{name}-load"], out[f"{name}-dropped"] = st.load, st.dropped
    for k in range(STEPS):
        logits, caches = model.decode_step(params, torch.from_numpy(
            inputs[f"decode-{name}"][k]).long(), caches)
        out[f"{name}-decode{k}"] = logits

# the engine on (2, 2), before and after the placement
g = groups[(2, 2)]
policy = FinDEPPolicy(FinDEPPlanner(cfg, DepClusterConfig(4, 2, 2),
                                    PAPER_A6000,
                                    PlannerConfig(mem_cap_samples=8)))
eng = ServingEngine(cfg, params=shard_experts(full, g.expert_rank, 2),
                    num_slots=4, max_context=64, dtype=torch.float32,
                    device="cpu", seed=0, plan_policy=policy, ep_group=g,
                    replicate_hot_k=1, rebalance_threshold=1e9)
experts = eng.params["layers"][1]["moe"]["experts"]
ptrs = {k: v.data_ptr() for k, v in experts.items()}
for w, prompts in enumerate(PROMPTS):
    if w:
        pl = eng.rebalance_now(Placement(4, 2, ASSIGNMENT, HOT, epoch=1))
        assert pl == Placement(4, 2, ASSIGNMENT, HOT, epoch=1), pl
        assert {k: v.data_ptr() for k, v in experts.items()} == ptrs
        for k, v in experts.items():
            out[f"placed-{k}"] = v.clone()
        hot = eng._device_placement.hot_weights[1]
        for k, v in hot.items():
            out[f"hot-{k}"] = v
    reqs = [Request(prompt=p, max_new_tokens=NEW) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run()
    out[f"tokens-{w}"] = torch.tensor([r.output for r in reqs])
out["engine-dropped"] = torch.tensor(eng.stats.dropped_tokens)
out["headers"] = torch.tensor(eng._lockstep.headers)
np.savez(f"{d}/rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    cfg = jax_smoke(ARCH)
    params = jax_build(cfg, dtype=jnp.float32).init(jax.random.PRNGKey(0))
    layer = jmoe.moe_init(jax.random.PRNGKey(1), cfg.d_model, cfg.moe, 4)
    rng = np.random.RandomState(0)
    arrays = dict(_flatten(params, "model"))
    arrays.update(_flatten(layer, "layer"))
    for S in MODE_LENGTHS:
        arrays[f"x{S}"] = rng.randn(2, S, cfg.d_model).astype(np.float32)
    for name, _, B, S in MODEL_CASES:
        arrays[f"tokens-{name}"] = rng.randint(1, cfg.vocab_size, (B, S))
        arrays[f"decode-{name}"] = rng.randint(1, cfg.vocab_size,
                                               (DECODE_STEPS, B, 1))
    for w, lens in (("before", REQS_BEFORE), ("after", REQS_AFTER)):
        arrays[f"prompts-{w}"] = len(lens)
        for i, n in enumerate(lens):
            arrays[f"prompt-{w}-{i}"] = rng.randint(1, cfg.vocab_size, n)
    np.savez(d / "inputs.npz", model_cases=np.array(
        [(n, a, b, B, S) for n, (a, b), B, S in MODEL_CASES]).astype(str),
        steps=DECODE_STEPS, assignment=np.array(ASSIGNMENT),
        hot=np.array(HOT), new_tokens=NEW_TOKENS, **arrays)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    golden = subprocess.Popen(
        [sys.executable, "-c", _GOLDEN, str(d)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    workers = [subprocess.Popen([sys.executable, "-c", _WORKER, str(d),
                                 str(r)], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
               for r in range(4)]
    for p in [golden] + workers:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    shards = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return dict(np.load(d / "golden.npz")), shards, params


@pytest.mark.parametrize("S", MODE_LENGTHS)
def test_sequence_mode_from_the_global_length(runs, S):
    """At S = 4 and 8 over 4 expert ranks the reference takes sequence
    mode. Each rank's output, given the mode of the global length, is
    its slice of the reference's at 1e-5; given the mode of its own
    1 or 2 positions (the port's old rule: replicated, whose all_reduce
    sums the four ranks' different tokens), it misses by far."""
    golden, shards, _ = runs
    want = golden[f"mode-{S}"]
    got = np.concatenate([s[f"mode-{S}-global"] for s in shards], axis=1)
    assert np.abs(got - want).max() < TOL
    old = np.concatenate([s[f"mode-{S}-local"] for s in shards], axis=1)
    assert np.abs(old - want).max() > 100 * TOL


@pytest.mark.parametrize("case", [c[0] for c in MODEL_CASES])
def test_prefill_and_decode_match_reference_on_mesh(runs, case):
    """Every rank's prefill logits, MoE stats (global load histogram and
    dropped count) and decode logits equal the reference model's on the
    same layout, at 1e-5: each rank holds the whole residual stream."""
    golden, shards, _ = runs
    assert int(golden[f"{case}-dropped"]) > 0
    for s in shards:
        assert np.abs(s[f"{case}-prefill"]
                      - golden[f"{case}-prefill"]).max() < TOL
        assert np.array_equal(s[f"{case}-load"], golden[f"{case}-load"])
        assert int(s[f"{case}-dropped"]) == int(golden[f"{case}-dropped"])
        for k in range(DECODE_STEPS):
            name = f"{case}-decode{k}"
            assert np.abs(s[name] - golden[name]).max() < TOL


def test_cross_rank_placement_matches_reference_engine(runs):
    """On (2, 2) the engines give the reference's tokens before and after
    the same placement. Afterwards each rank's expert tensors (the same
    storage as before) hold its two rows of the reference's permuted
    stack, two of which came from the other expert rank; the hot expert's
    weights, fetched from the rank that owns its row, equal its row; and
    the ranks exchanged lock-step headers."""
    golden, shards, _ = runs
    perm = (2, 0, 1, 3)                  # the placement's physical rows
    for s in shards:
        for w in (0, 1):
            assert np.array_equal(s[f"tokens-{w}"], golden[f"tokens-{w}"])
        assert int(s["engine-dropped"]) == int(golden["engine-dropped"])
        assert int(s["headers"]) > 0
    for r, s in enumerate(shards):
        m = r % 2
        for k in ("gate", "up", "down"):
            want = golden[f"placed-{k}"]
            assert np.array_equal(s[f"placed-{k}"], want[2 * m:2 * m + 2])
            assert np.array_equal(s[f"hot-{k}"], want[[perm[e]
                                                        for e in HOT]])
    moved = [e for e in range(4) if ASSIGNMENT[e] != e // 2]
    assert {ASSIGNMENT[e] for e in moved} == {0, 1}


@pytest.mark.parametrize("mo", [2, 4])
def test_init_shards_equal_one_rank_rows(mo):
    """``Model.init(expert_shard=(r, mo))`` keeps rows [r·E/mo,
    (r+1)·E/mo) of the one-rank model's stacked experts and every other
    parameter bitwise, from the same generator seed."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    cpu = torch.device("cpu")
    whole = model.init(generator_for(cpu, 0))
    E = cfg.moe.num_experts
    for r in range(mo):
        part = model.init(generator_for(cpu, 0), expert_shard=(r, mo))
        for lw, lp in zip(whole["layers"], part["layers"]):
            for k, v in lw["moe"]["experts"].items():
                got = lp["moe"]["experts"][k]
                assert got.shape[0] == E // mo
                assert torch.equal(got, v[r * E // mo:(r + 1) * E // mo])
            assert torch.equal(lp["moe"]["router"]["kernel"],
                               lw["moe"]["router"]["kernel"])
            assert torch.equal(lp["attn"]["wq"]["kernel"],
                               lw["attn"]["wq"]["kernel"])
        assert torch.equal(part["embed"]["embedding"],
                           whole["embed"]["embedding"])


_WIDE = DepGroups(expert=None, expert_rank=0, expert_size=2, data=None,
                  world=None, world_size=2)


def test_unsharded_weights_on_a_wide_group_are_refused():
    """Given weights on an expert group of 2 must hold E/2 experts a MoE
    layer; the whole stack raises."""
    cfg = get_smoke_config(ARCH)
    params = build_model(cfg, dtype=torch.float32, device="cpu").init(
        generator_for(torch.device("cpu"), 0))
    with pytest.raises(ValueError, match="shard_experts"):
        ServingEngine(cfg, params=params, device="cpu", ep_group=_WIDE,
                      plan_policy=None)


def test_serve_moe_nccl_with_too_few_cards_is_refused():
    """``--backend nccl`` needs a card per rank: with fewer (none here),
    ``serve_moe`` raises before it spawns a rank."""
    with pytest.raises(ValueError, match="card"):
        serve_moe.main(["--device", "cpu", "--ep-size", "2",
                        "--backend", "nccl"])


def test_lockstep_header_round_trip():
    """A lock-step header carries a program (lowering scalars, interleave
    and priority hints), a placement and a float exactly; the decoded
    program equals and hashes as the encoded one, so it keys the same
    decode graph. A group of one rank sends nothing."""
    from repro_torch.core import taskgraph as tg
    from repro_torch.placement import Placement
    from repro_torch.runtime import lockstep as ls
    graph = tg.lower_exec(4, "ASAS", 3, hot_experts=2, placement_epoch=5,
                          r1=2)
    hints = tg.schedule(graph, tg.TaskCosts(attn=1.0, shared=2.0, exp=3.0,
                                            comm=5.0)).priority_hints()
    for prog in (tg.ExecProgram(graph, "streams", hints),
                 tg.ExecProgram(tg.lower_exec(1, "AASS", 1), "off"), None):
        got, rest = ls.decode_program(ls.encode_program(prog) + [7, 8])
        assert got == prog and hash(got) == hash(prog) and rest == [7, 8]
    pl = Placement(4, 2, (1, 0, 0, 1), (3,), epoch=2)
    for p in (pl, None):
        assert ls.decode_placement(ls.encode_placement(p)) == p
    for x in (1.0, 2.0, 0.1, 4.0 / 3.0):
        assert ls.bits_float(ls.float_bits(x)) == x
    one = ls.LockStep(None)
    assert not one.active and one.lead
    assert one.follow([3, 1]) == [3, 1]
    assert one.follow_call(None, 5, 2.0) == (None, 5, 2.0)
    assert one.headers == 0
