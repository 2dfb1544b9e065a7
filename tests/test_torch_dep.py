"""The DEP executor on ``torch.distributed`` (``repro_torch.core.dep``)
across four gloo ranks on the CPU, a (2 data x 2 expert) layout, held
against the reference's ``moe_apply_dep`` on a forced 4-device host mesh
and against the dense oracle (f32, 1e-5), at the smoke qwen2-moe-a2.7b
with capacity factor 8 (no drops): sequence mode and replicated decode,
ASAS and AASS, r1 and r2 in {1, 2, 4}, m_e = 3. ``interleave="streams"``
must give the ``"off"`` walk's bits; a placement's REP splice must give
the wire round trip's bits; and an A2E receive permute left transposed
must fail the 1e-5 check (the permute is what the check guards).

The reference runs in one subprocess and the four ranks in four more,
all at once; each rank writes its shard of every case to a file."""
import dataclasses
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-5
E_PAD = 4
#: (mode, order, r1, r2); every case at m_e = 3
CASES = list(itertools.product(("seq", "dec"), ("ASAS", "AASS"), (1, 2, 4),
                               (1, 2, 4)))
#: the stats cases: capacity factor 0.5 widened by capacity_scale 2.0,
#: r1 = 1 at m_e = 1, r2 = 2 chunks in sequence mode and 1 in decode (two
#: tokens a rank, whose capacity of 1 a shared expert overflows)
STATS_CF, STATS_SCALE = 0.5, 2.0

#: a non-identity placement of the 4 experts on 2 ranks: rank 0 owns
#: experts 1 and 2, rank 1 experts 0 and 3 (perm (2, 0, 1, 3)); expert 0
#: is the replicated hot one
ASSIGNMENT = (1, 0, 0, 1)


def _case_id(case):
    return "-".join(map(str, case))


def _flatten(tree, prefix="p"):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


_COMMON = r"""
import sys
import numpy as np

d = sys.argv[1]
inputs = np.load(f"{d}/inputs.npz")
CASES = [(m, o, int(a), int(b)) for m, o, a, b in inputs["cases"]]
ASSIGNMENT = tuple(int(a) for a in inputs["assignment"])


def tree(f, prefix="p"):
    out = {}
    for key in inputs.files:
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key.split("/")[1:]
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = f(inputs[key])
    return out


def key(case, il):
    return "-".join(map(str, case)) + "-" + il
"""

_GOLDEN = _COMMON + r"""
import dataclasses
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.core import dep
from repro.core.taskgraph import ExecProgram, lower_exec
from repro.models import moe as moe_lib
from repro.models.transformer import ExecutionContext
from repro.placement import Placement

mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
ctx = ExecutionContext(mesh=mesh, moe_impl="dep")
mcfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b").moe,
                           capacity_factor=8.0)
params = tree(jnp.asarray)
xs = {"seq": jnp.asarray(inputs["xs"]), "dec": jnp.asarray(inputs["xd"])}


def run(p, x, prog, placement=None):
    with mesh:
        return jax.jit(lambda p, x: dep.moe_apply_dep(
            p, x, mcfg, ctx, 4, plan=prog, placement=placement))(p, x)


out = {}
for mode, x in xs.items():
    out[f"dense-{mode}"] = moe_lib.moe_apply_dense(params, x, mcfg, 4)[0]
for case in CASES:
    mode, order, r1, r2 = case
    y, aux = run(params, xs[mode],
                 ExecProgram(lower_exec(r2, order, 3, r1=r1), "off"))
    out[key(case, "off")], out[key(case, "aux")] = y, aux
# the placed layer: physical row perm[e] holds logical expert e
for hot in (0, 1):
    pl = Placement(4, 2, ASSIGNMENT, replicated=(0,) if hot else ())
    inv = np.argsort(np.asarray(pl.perm))
    phys = dict(params, experts={k: v[inv] for k, v in
                                 params["experts"].items()})
    prog = ExecProgram(lower_exec(2, "ASAS", 1, hot_experts=hot, r1=2),
                       "streams")
    out[f"placed-{hot}"] = run(phys, xs["seq"], prog, pl)[0]
tight = dataclasses.replace(mcfg, capacity_factor=float(inputs["stats_cf"]))
for mode, x in xs.items():
    with mesh:
        y, _, st = jax.jit(lambda p, x: dep.moe_apply_dep(
            p, x, tight, ctx, 4,
            plan=ExecProgram(lower_exec(2 if mode == "seq" else 1, "ASAS",
                                        1), "off"),
            return_stats=True,
            capacity_scale=float(inputs["stats_scale"])))(params, x)
    out[f"stats-{mode}"], out[f"stats-{mode}-load"] = y, st.load
    out[f"stats-{mode}-dropped"] = st.dropped
np.savez(f"{d}/golden.npz", **{k: np.asarray(v) for k, v in out.items()})
"""

_WORKER = _COMMON + r"""
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.core import dep
from repro_torch.core.taskgraph import ExecProgram, lower_exec
from repro_torch.placement import Placement
import dataclasses

torch.set_num_threads(1)
rank = int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"file://{d}/store",
                        rank=rank, world_size=4)
groups = dep.DepGroups.build(2, 2)
dd, m = divmod(rank, 2)
assert (groups.expert_rank, groups.expert_size) == (m, 2)
mcfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b").moe,
                           capacity_factor=8.0)
params = tree(torch.from_numpy)
local = dict(params, experts={k: v[2 * m:2 * m + 2]
                              for k, v in params["experts"].items()})
xs = {"seq": torch.from_numpy(inputs["xs"])[2 * dd:2 * dd + 2,
                                             4 * m:4 * m + 4],
      "dec": torch.from_numpy(inputs["xd"])[2 * dd:2 * dd + 2]}


#: the global sequence (8 positions) splits over the 2 expert ranks; the
#: decode position does not; the batch of 4 splits over the 2 data ranks
SPLIT = {"seq": dict(sequence=True, batch_sharded=True),
         "dec": dict(sequence=False, batch_sharded=True)}


def run(p, x, prog, mode, **kw):
    return dep.moe_apply_dep(p, x, mcfg, groups, 4, plan=prog, **SPLIT[mode],
                             **kw)


out = {}
for case in CASES:
    mode, order, r1, r2 = case
    graph = lower_exec(r2, order, 3, r1=r1)
    for il in ("off", "streams"):
        y, aux = run(local, xs[mode], ExecProgram(graph, il), mode)
        out[key(case, il)] = y
    out[key(case, "aux")] = aux
for hot in (0, 1):
    pl = Placement(4, 2, ASSIGNMENT, replicated=(0,) if hot else ())
    inv = np.argsort(np.asarray(pl.perm))
    phys = {k: v[inv] for k, v in params["experts"].items()}
    placed = dict(params, experts={k: v[2 * m:2 * m + 2]
                                   for k, v in phys.items()})
    lp = dep.DevicePlacement.build(pl, [{"moe": {"experts": phys}}],
                                   torch.device("cpu")).layer(0)
    prog = ExecProgram(lower_exec(2, "ASAS", 1, hot_experts=hot, r1=2),
                       "streams")
    out[f"placed-{hot}"] = run(placed, xs["seq"], prog, "seq",
                               **lp._asdict())[0]
tight = dataclasses.replace(mcfg, capacity_factor=float(inputs["stats_cf"]))
for mode, x in xs.items():
    y, _, st = dep.moe_apply_dep(
        local, x, tight, groups, 4,
        plan=ExecProgram(lower_exec(2 if mode == "seq" else 1, "ASAS", 1),
                         "off"), return_stats=True,
        capacity_scale=float(inputs["stats_scale"]), **SPLIT[mode])
    out[f"stats-{mode}"], out[f"stats-{mode}-load"] = y, st.load
    out[f"stats-{mode}-dropped"] = st.dropped
# the control: the A2E receive permute left transposed
dep._a2e_layout = lambda recv: recv.reshape(
    recv.shape[1], recv.shape[0] * recv.shape[2], recv.shape[3])
out["control"] = run(local, xs["seq"],
                     ExecProgram(lower_exec(1, "AASS", 1), "off"), "seq")[0]
np.savez(f"{d}/rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
"""


def _assemble(shards, name, mode):
    """The global output of ``name`` from the four ranks' shards: in
    sequence mode rank (d, m) holds batch rows 2d..2d+1 and positions
    4m..4m+3; in decode both expert peers of a data shard hold the same
    rows (checked bitwise)."""
    if mode == "seq":
        return np.concatenate([np.concatenate(
            [shards[2 * d + m][name] for m in range(2)], axis=1)
            for d in range(2)], axis=0)
    for d in range(2):
        assert np.array_equal(shards[2 * d][name], shards[2 * d + 1][name])
    return np.concatenate([shards[2 * d][name] for d in range(2)], axis=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dep")
    mcfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b").moe,
                               capacity_factor=8.0)
    params = jmoe.moe_init(jax.random.PRNGKey(1), 256, mcfg, E_PAD)
    rng = np.random.RandomState(0)
    np.savez(d / "inputs.npz",
             xs=rng.randn(4, 8, 256).astype(np.float32),
             xd=rng.randn(4, 1, 256).astype(np.float32),
             cases=np.array(CASES, dtype=object).astype(str),
             assignment=np.array(ASSIGNMENT), stats_cf=STATS_CF,
             stats_scale=STATS_SCALE, **dict(_flatten(params)))
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
    return dict(np.load(d / "golden.npz")), shards


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_dep_matches_reference_and_dense(runs, case):
    golden, shards = runs
    mode = case[0]
    name = f"{_case_id(case)}-off"
    y = _assemble(shards, name, mode)
    assert np.abs(y - golden[name]).max() < TOL
    assert np.abs(y - golden[f"dense-{mode}"]).max() < TOL
    aux = [float(s[f"{_case_id(case)}-aux"]) for s in shards]
    assert max(aux) == min(aux)
    assert abs(aux[0] - float(golden[f"{_case_id(case)}-aux"])) < TOL


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_streams_bitwise_equal_to_off(runs, case):
    _, shards = runs
    for s in shards:
        assert np.array_equal(s[f"{_case_id(case)}-streams"],
                              s[f"{_case_id(case)}-off"])


def test_rep_splice_bitwise_equal_to_wire(runs):
    """A non-identity placement with a replicated hot expert: the REP
    splice gives the wire round trip's bits; both agree with the
    reference's placed layer and with the dense oracle."""
    golden, shards = runs
    wire = _assemble(shards, "placed-0", "seq")
    rep = _assemble(shards, "placed-1", "seq")
    assert np.array_equal(rep, wire)
    for name, y in (("placed-0", wire), ("placed-1", rep)):
        assert np.abs(y - golden[name]).max() < TOL
        assert np.abs(y - golden["dense-seq"]).max() < TOL


@pytest.mark.parametrize("mode", ["seq", "dec"])
def test_stats_and_capacity_scale_match_reference(runs, mode):
    """``return_stats`` with ``capacity_scale``: every rank holds the
    reference's global load histogram (logical ids) and dropped count,
    summed over the ranks that shard the tokens (the data axis, and in
    sequence mode the expert axis too); some assignments drop, and the
    output matches the reference's at 1e-5."""
    golden, shards = runs
    want_load = golden[f"stats-{mode}-load"]
    want_dropped = int(golden[f"stats-{mode}-dropped"])
    assert want_dropped > 0
    for s in shards:
        assert np.array_equal(s[f"stats-{mode}-load"], want_load)
        assert int(s[f"stats-{mode}-dropped"]) == want_dropped
    y = _assemble(shards, f"stats-{mode}", mode)
    assert np.abs(y - golden[f"stats-{mode}"]).max() < TOL


def test_transposed_a2e_permute_fails(runs):
    """The control: with the A2E receive permute transposed, the sequence
    walk must miss the reference by more than the tolerance."""
    golden, shards = runs
    y = _assemble(shards, "control", "seq")
    assert np.abs(y - golden["dense-seq"]).max() > 100 * TOL
