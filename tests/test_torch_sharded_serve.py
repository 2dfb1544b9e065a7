"""The sharded prefill and decode bundles (``launch.steps.build(cfg,
prefill or decode shape, mesh=DeviceMesh)``) on gloo CPU ranks, held
against the reference's bundles on a plain ``jax.sharding.Mesh`` of
forced host devices (jitted with the bundles' shardings) on the same
weights, f32, at 1e-5:

  * ("data", "model") layouts (1, 2) and (2, 2) of the smoke
    qwen2-moe-a2.7b (capacity factor 4: nothing dropped), whose heads
    divide the model axis: each rank attends its own heads;
  * two layouts where the KV heads do not divide the model axis (one KV
    head): a sliding window of 8 slots at (1, 2), decoded across the
    ring's wrap, and full attention at (2, 2). The cache is split along
    the sequence and decode runs ``attention.decode_core_seqsharded``
    on the port's side and ``_decode_core_seqsharded`` on the
    reference's.

Per layout: the prefill step's logits and caches (each rank's rows and
shards, assembled); from a cache the reference prefills to 16 slots,
six teacher-forced decode steps (``sharded_decode``'s logits against
the reference's ``decode_step`` under the bundle's shardings) and then
the bundle's serve step (greedy tokens and caches); the bundles'
placements of parameters, tokens and caches against the reference
bundles' ``in_shardings``.

The sequence-sharded core alone: the port's ``decode_core_seqsharded``
on two ranks against the reference's ``_decode_core_seqsharded`` at a
scalar index inside the cache, at the cache's last slot and across a
ring's wrap; a control whose new row lands one slot late must miss the
limit in every case.

Every other family against the port's own unsharded bundle on the same
weights (f32, 1e-5; the reference is held to it above): prefill logits
and three decode steps' logits on each rank at (1, 2) for qwen2-1.5b
(the dense MLP, the tied vocab-split readout), recurrentgemma-9b (the
RG-LRU block's split channels; one KV head: the local-attention ring
split along the sequence), seamless-m4t-large-v2 (the encoder and
cross-attention) and xlstm-1.3b (the replicated blocks, the vocab-split
embedding and head), and internvl2-1b at (1, 4), whose two heads do not
divide the axis (every rank attends every head) behind the split `proj`.

The reference runs in one subprocess and the 24 ranks in 24 more, all
at once."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, P, C, T = 4, 6, 16, 6
TOL = dict(rtol=1e-5, atol=1e-5)
#: tag -> (data, model, variant, the port's attn_impl)
LAYOUTS = {"1x2": (1, 2, "heads", "xla"),
           "2x2": (2, 2, "heads", "decode_kernel"),
           "seq-ring": (1, 2, "ring", "decode_kernel"),
           "seq-full": (2, 2, "seqfull", "xla")}
CORE_CASES = ((5, False), (C - 1, False), (13, True), (21, True))

_COMMON = r"""
import dataclasses, json, sys
import numpy as np

d = sys.argv[1]
B, P, C, T = 4, 6, 16, 6
LAYOUTS = {"1x2": (1, 2, "heads"), "2x2": (2, 2, "heads"),
           "seq-ring": (1, 2, "ring"), "seq-full": (2, 2, "seqfull")}
CORE = ((5, False), (C - 1, False), (13, True), (21, True))


def config(smoke, variant):
    cfg = smoke("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    if variant == "ring":
        cfg = dataclasses.replace(cfg, num_kv_heads=1, attention="sliding",
                                  sliding_window=8)
    elif variant == "seqfull":
        cfg = dataclasses.replace(cfg, num_kv_heads=1)
    return cfg


def inputs(variant):
    f = np.load(f"{d}/inputs-{variant}.npz")
    n = int(f["n_leaves"])
    return [f[f"leaf_{i}"] for i in range(n)], f
"""

_GOLDEN = _COMMON + r"""
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch import steps
from repro.models.attention import _decode_core_seqsharded

out = {}


def _dims(spec, ndim):
    ent = tuple(spec) + (None,) * (ndim - len(spec))
    return [[] if e is None else [e] if isinstance(e, str) else list(e)
            for e in ent]


for tag, (dp, mo, variant) in LAYOUTS.items():
    cfg = config(get_smoke_config, variant)
    leaves, f = inputs(variant)
    mesh = Mesh(np.array(jax.devices()[:dp * mo]).reshape(dp, mo),
                ("data", "model"))
    pb = steps.build(cfg, ShapeConfig("p", P, B, "prefill"), mesh=mesh,
                     dtype=jnp.float32, scan_layers=False)
    db = steps.build(cfg, ShapeConfig("d", C, B, "decode"), mesh=mesh,
                     dtype=jnp.float32, scan_layers=False)
    like = jax.eval_shape(pb.model.init, jax.random.PRNGKey(0))
    params = jax.tree.unflatten(jax.tree.structure(like),
                                [jnp.asarray(x) for x in leaves])
    # the layout of every parameter, the tokens and the decode caches
    lay = [_dims(sh.spec, a.ndim) for sh, a in zip(
        jax.tree.leaves(db.in_shardings[0]), jax.tree.leaves(like))]
    lay.append(_dims(db.in_shardings[1].spec, 2))
    lay += [_dims(sh.spec, a.ndim) for sh, a in zip(
        jax.tree.leaves(db.in_shardings[2]),
        jax.tree.leaves(db.abstract_args[2]))]
    out[f"{tag}-layout"] = np.array(json.dumps(lay))
    with mesh:
        logits, caches = jax.jit(pb.step_fn, in_shardings=pb.in_shardings)(
            params, jnp.asarray(f["prompt"]))
        out[f"{tag}-prefill-logits"] = logits
        for i, x in enumerate(jax.tree.leaves(caches)):
            out[f"{tag}-prefill-cache-{i}"] = x
        # the decode start: the unsharded model prefills to C slots
        one = steps.make_model(cfg, None, scan_layers=False,
                               dtype=jnp.float32)
        _, caches = jax.jit(lambda p, t: one.prefill(p, t, seq_budget=C))(
            params, jnp.asarray(f["prompt"]))
        for i, x in enumerate(jax.tree.leaves(caches)):
            out[f"{tag}-start-{i}"] = x
        dec = jax.jit(db.model.decode_step,
                      in_shardings=db.in_shardings[:3])
        for t in range(T):
            logits, caches = dec(params, jnp.asarray(f["forced"][:, t:t + 1]),
                                 caches)
            out[f"{tag}-decode-{t}"] = logits
        serve = jax.jit(db.step_fn, in_shardings=db.in_shardings)
        tok, caches = serve(params, jnp.asarray(f["forced"][:, T:T + 1]),
                            caches)
        out[f"{tag}-next"] = tok
        for i, x in enumerate(jax.tree.leaves(caches)):
            out[f"{tag}-final-{i}"] = x

# the sequence-sharded core alone on a (1, 2) mesh
core = np.load(f"{d}/core.npz")
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
with mesh:
    for n, (index, ring) in enumerate(CORE):
        o, k, v = jax.jit(lambda *a: _decode_core_seqsharded(
            *a, mesh, "model", None, ring))(
            jnp.asarray(core["q"]), jnp.asarray(core["kn"]),
            jnp.asarray(core["vn"]), jnp.asarray(core["ck"]),
            jnp.asarray(core["cv"]), jnp.asarray(index, jnp.int32))
        out[f"core-{n}-out"], out[f"core-{n}-k"] = o, k
np.savez(f"{d}/golden.npz", **{k: np.asarray(v) for k, v in out.items()})
"""

_RANK = _COMMON + r"""
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

torch.set_num_threads(1)
rank, tag, impl = int(sys.argv[2]), sys.argv[3], sys.argv[4]
dp, mo, variant = LAYOUTS[tag]
dist.init_process_group("gloo", init_method=f"file://{d}/store-{tag}",
                        rank=rank, world_size=dp * mo)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.attention import decode_core_seqsharded
from repro_torch.models.parallel import TensorParallel
from repro_torch.sharding.partition import distribute_params, local_shard
from repro_torch.training.tree import tree_leaves, tree_unflatten

cfg = config(get_smoke_config, variant)
leaves, f = inputs(variant)
mesh = make_host_mesh(model=mo, data=dp)
pb = steps.build(cfg, ShapeConfig("p", P, B, "prefill"), mesh=mesh,
                 dtype=torch.float32, device="cpu", attn_impl=impl)
db = steps.build(cfg, ShapeConfig("d", C, B, "decode"), mesh=mesh,
                 dtype=torch.float32, device="cpu", attn_impl=impl)
full = tree_unflatten(pb.abstract_args[0],
                      [torch.from_numpy(x) for x in leaves])
params = distribute_params(full, pb.placements[0], mesh)
out = {}
names = mesh.mesh_dim_names


def dims(pl, ndim):
    return [[names[i] for i, p in enumerate(pl)
             if isinstance(p, Shard) and p.dim == dim] for dim in range(ndim)]


lay = [dims(pl, a.ndim) for pl, a in zip(
    tree_leaves(db.placements[0], tuple), tree_leaves(db.abstract_args[0]))]
lay.append(dims(db.placements[1], 2))
lay += [dims(pl, a.ndim) for pl, a in zip(
    tree_leaves(db.placements[2], tuple), tree_leaves(db.abstract_args[2]))]
out["layout"] = np.array(json.dumps(lay))
prompt, forced = torch.from_numpy(f["prompt"]), torch.from_numpy(f["forced"])
logits, caches = pb.step_fn(params, prompt)
out["prefill-logits"] = logits.numpy()
for i, x in enumerate(tree_leaves(caches)):
    out[f"prefill-cache-{i}"] = x.numpy()
start = np.load(f"{d}/golden.npz")
glob = tree_unflatten(db.abstract_args[2], [
    torch.from_numpy(start[f"{tag}-start-{i}"])
    for i in range(len(tree_leaves(db.abstract_args[2])))])
caches = tree_unflatten(glob, [
    local_shard(x, pl, mesh) for x, pl in zip(
        tree_leaves(glob), tree_leaves(db.placements[2], tuple))])
for t in range(T):
    logits, caches = steps.sharded_decode(db.model, mesh, db.placements[0],
                                          params, forced[:, t:t + 1], caches)
    out[f"decode-{t}"] = logits.numpy()
tok, caches = db.step_fn(params, forced[:, T:T + 1], caches)
out["next"] = tok.numpy()
for i, x in enumerate(tree_leaves(caches)):
    out[f"final-{i}"] = x.numpy()
if tag == "seq-ring":
    core = np.load(f"{d}/core.npz")
    tp = TensorParallel.from_mesh(mesh)
    Cl = C // mo
    for n, (index, ring) in enumerate(CORE):
        slot = index % C if ring else min(index, C - 1)
        ck, cv = core["ck"].copy(), core["cv"].copy()
        kn, vn = core["kn"], core["vn"]
        for name in ("out", "control"):
            if name == "control":
                # the new row one slot late: written at slot + 1 by hand,
                # and the core given the slot's old row to write back
                late = (slot + 1) % C
                ck, cv = core["ck"].copy(), core["cv"].copy()
                ck[:, late], cv[:, late] = kn[:, 0], vn[:, 0]
                kn, vn = ck[:, slot:slot + 1], cv[:, slot:slot + 1]
            mine = slice(rank * Cl, (rank + 1) * Cl)
            o, k, _ = decode_core_seqsharded(
                torch.from_numpy(core["q"]), torch.from_numpy(kn.copy()),
                torch.from_numpy(vn.copy()), torch.from_numpy(ck[:, mine]),
                torch.from_numpy(cv[:, mine]),
                torch.tensor(index, dtype=torch.int32), tp, ring)
            out[f"core-{n}-{name}"] = o.numpy()
            if name == "out":
                out[f"core-{n}-k"] = k.numpy()
np.savez(f"{d}/port-{tag}-{rank}.npz", **out)
dist.destroy_process_group()
"""


#: family checks against the unsharded port: arch -> model axis
FAMILIES = {"qwen2-1.5b": 2, "recurrentgemma-9b": 2,
            "seamless-m4t-large-v2": 2, "xlstm-1.3b": 2, "internvl2-1b": 4}

_FAMILY = r"""
import json, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
d, arch, rank, mo = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{d}/store-{arch}",
                        rank=rank, world_size=mo)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.partition import distribute_params, local_shard
from repro_torch.training.tree import tree_leaves, tree_unflatten

B, P, C = 2, 6, 16
cfg = get_smoke_config(arch)
mesh = make_host_mesh(model=mo)
kw = dict(dtype=torch.float32, device="cpu", attn_impl="decode_kernel")
one = steps.build(cfg, ShapeConfig("d", C, B, "decode"), **kw)
pb = steps.build(cfg, ShapeConfig("p", P, B, "prefill"), mesh=mesh, **kw)
db = steps.build(cfg, ShapeConfig("d", C, B, "decode"), mesh=mesh, **kw)
model = one.model
params = model.init(torch.Generator().manual_seed(0))
shards = distribute_params(params, pb.placements[0], mesh)
gen = torch.Generator().manual_seed(1)
tok = torch.randint(0, cfg.vocab_size, (B, P + 4), generator=gen)
extra = steps.frontend_inputs(cfg, B, P, torch.Generator().manual_seed(2),
                              device="cpu", dtype=torch.float32)
memory = None
if cfg.is_encoder_decoder:
    memory, ex = model.encode(params, extra), None
else:
    ex = extra
errs = {}


def err(name, got, want):
    errs[name] = float(((got - want).abs()
                        / (1e-5 + 1e-5 * want.abs())).max())


want, _ = steps.make_prefill_step(model)(params, tok[:, :P], extra)
got, _ = pb.step_fn(shards, tok[:, :P], extra)
err("prefill", got, want)
_, caches = model.prefill(params, tok[:, :P], extra_embeds=ex,
                          memory=memory, seq_budget=C)
local = tree_unflatten(caches, [local_shard(x, pl, mesh) for x, pl in zip(
    tree_leaves(caches), tree_leaves(db.placements[2], tuple))])
for t in range(3):
    want, caches = model.decode_step(params, tok[:, P + t:P + t + 1], caches,
                                     memory=memory)
    got, local = steps.sharded_decode(db.model, mesh, db.placements[0],
                                      shards, tok[:, P + t:P + t + 1],
                                      local, memory)
    err(f"decode-{t}", got, want)
if rank == 0:
    with open(f"{d}/family-{arch}.json", "w") as f:
        json.dump(errs, f)
dist.destroy_process_group()
"""


def _config(variant):
    cfg = jax_smoke("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    if variant == "ring":
        cfg = dataclasses.replace(cfg, num_kv_heads=1, attention="sliding",
                                  sliding_window=8)
    elif variant == "seqfull":
        cfg = dataclasses.replace(cfg, num_kv_heads=1)
    return cfg


def _run(tmp_path):
    rng = np.random.RandomState(3)
    for variant in ("heads", "ring", "seqfull"):
        cfg = _config(variant)
        model = jsteps.make_model(cfg, None, scan_layers=False,
                                  dtype=jax.numpy.float32)
        leaves = [np.asarray(x) for x in
                  jax.tree.leaves(model.init(jax.random.PRNGKey(0)))]
        np.savez(tmp_path / f"inputs-{variant}.npz",
                 prompt=rng.randint(0, cfg.vocab_size, (B, P)).astype(
                     np.int32),
                 forced=rng.randint(0, cfg.vocab_size, (B, T + 1)).astype(
                     np.int32),
                 n_leaves=len(leaves),
                 **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    H, Kv, D = 4, 1, 64
    np.savez(tmp_path / "core.npz",
             q=rng.randn(B, 1, H, D).astype(np.float32),
             kn=rng.randn(B, 1, Kv, D).astype(np.float32),
             vn=rng.randn(B, 1, Kv, D).astype(np.float32),
             ck=rng.randn(B, C, Kv, D).astype(np.float32),
             cv=rng.randn(B, C, Kv, D).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    procs = []
    for arch, mo in FAMILIES.items():
        for r in range(mo):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _FAMILY, str(tmp_path), arch, str(r),
                 str(mo)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    golden = subprocess.run([sys.executable, "-c", _GOLDEN, str(tmp_path)],
                            env=env, capture_output=True, text=True,
                            timeout=600)
    assert golden.returncode == 0, golden.stdout + golden.stderr
    for tag, (dp, mo, _, impl) in LAYOUTS.items():
        for r in range(dp * mo):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK, str(tmp_path), str(r), tag,
                 impl], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out
    ports = {tag: [dict(np.load(tmp_path / f"port-{tag}-{r}.npz"))
                   for r in range(dp * mo)]
             for tag, (dp, mo, _, _) in LAYOUTS.items()}
    for arch in FAMILIES:
        with open(tmp_path / f"family-{arch}.json") as f:
            ports[arch] = json.load(f)
    return dict(np.load(tmp_path / "golden.npz")), ports


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("sharded_serve"))


def _assemble(ports, key, layout):
    """The global array of ``key`` from every rank's shard, by the
    bundle's layout (per dim, the mesh axes it is split over)."""
    dp, mo = LAYOUTS[ports["tag"]][:2]
    coords = [(r // mo, r % mo) for r in range(dp * mo)]
    shards = [p[key] for p in ports["ranks"]]
    shape = list(shards[0].shape)
    for dim, axes in enumerate(layout):
        for a in axes:
            shape[dim] *= dp if a == "data" else mo
    full = np.zeros(shape, shards[0].dtype)
    for (dd, mm), x in zip(coords, shards):
        idx = []
        for dim, axes in enumerate(layout):
            n, i = 1, 0
            for a in axes:
                size = dp if a == "data" else mo
                i = i * size + (dd if a == "data" else mm)
                n *= size
            w = shape[dim] // n
            idx.append(slice(i * w, (i + 1) * w))
        full[tuple(idx)] = x
    return full


def _rows(ports, key):
    """A batch-sharded output (each rank's data rows) made global: the
    ranks of one data row agree, and each data shard's rows in order."""
    dp, mo = LAYOUTS[ports["tag"]][:2]
    ranks = ports["ranks"]
    for d in range(dp):
        for m in range(1, mo):
            np.testing.assert_array_equal(ranks[d * mo][key],
                                          ranks[d * mo + m][key])
    return np.concatenate([ranks[d * mo][key] for d in range(dp)])


def _cache_layout(golden, tag):
    lay = json.loads(str(golden[f"{tag}-layout"]))
    n_cache = sum(1 for k in golden if k.startswith(f"{tag}-final-"))
    return lay[-n_cache:]


@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_placements_match_reference_shardings(results, tag):
    golden, ports = results
    for p in ports[tag]:
        assert json.loads(str(p["layout"])) == \
            json.loads(str(golden[f"{tag}-layout"]))


@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_prefill_matches_reference(results, tag):
    golden, ports = results
    pr = {"tag": tag, "ranks": ports[tag]}
    np.testing.assert_allclose(_rows(pr, "prefill-logits"),
                               golden[f"{tag}-prefill-logits"], **TOL)
    lay = _cache_layout(golden, tag)
    n = len(lay)
    for i in range(n):
        want = golden[f"{tag}-prefill-cache-{i}"]
        if want.ndim == 0:          # the index
            for p in ports[tag]:
                assert int(p[f"prefill-cache-{i}"]) == int(want)
            continue
        # the prefill's caches hold P slots (C for the decode bundle):
        # laid out by the decode bundle's rule at this capacity
        got = _assemble(pr, f"prefill-cache-{i}", lay[i])
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_decode_matches_reference(results, tag):
    golden, ports = results
    pr = {"tag": tag, "ranks": ports[tag]}
    for t in range(T):
        np.testing.assert_allclose(_rows(pr, f"decode-{t}"),
                                   golden[f"{tag}-decode-{t}"], **TOL)
    np.testing.assert_array_equal(_rows(pr, "next"), golden[f"{tag}-next"])
    lay = _cache_layout(golden, tag)
    for i, axes in enumerate(lay):
        want = golden[f"{tag}-final-{i}"]
        if want.ndim == 0:
            assert all(int(p[f"final-{i}"]) == int(want) for p in ports[tag])
            continue
        np.testing.assert_allclose(_assemble(pr, f"final-{i}", axes), want,
                                   **TOL)


def test_sequence_split_layouts_split_the_sequence(results):
    """The KV heads (one) do not divide the model axis: the decode caches
    are split along the sequence (dim 1), and the heads layouts split
    the KV heads (dim 2)."""
    golden, _ = results

    def k_layout(tag):          # the first layer's k: {index, k, v}
        return _cache_layout(golden, tag)[1]
    for tag in ("seq-ring", "seq-full"):
        k = k_layout(tag)
        assert k[1] == ["model"] and k[2] == [], (tag, k)
    assert k_layout("1x2")[2] == ["model"]
    assert k_layout("2x2")[:3] == [["data"], [], ["model"]]


@pytest.mark.parametrize("case", range(len(CORE_CASES)),
                         ids=[f"index{i}-{'ring' if r else 'full'}"
                              for i, r in CORE_CASES])
def test_seqsharded_core_matches_reference(results, case):
    golden, ports = results
    ranks = ports["seq-ring"]
    want = golden[f"core-{case}-out"]
    for p in ranks:                      # every rank has the whole output
        np.testing.assert_allclose(p[f"core-{case}-out"], want, **TOL)
    Cl = C // 2
    got_k = np.concatenate([p[f"core-{case}-k"] for p in ranks], axis=1)
    np.testing.assert_allclose(got_k, golden[f"core-{case}-k"], **TOL)
    assert Cl * 2 == got_k.shape[1]
    # the control: the new row one slot late
    err = np.abs(ranks[0][f"core-{case}-control"] - want) \
        / (TOL["atol"] + TOL["rtol"] * np.abs(want))
    assert err.max() > 1.0


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_matches_unsharded_bundle(results, arch):
    """Each error is the worst |sharded - unsharded| over its limit
    1e-5 + 1e-5 |unsharded|: above 1 fails."""
    _, ports = results
    errs = ports[arch]
    assert set(errs) == {"prefill", "decode-0", "decode-1", "decode-2"}
    assert max(errs.values()) <= 1.0, errs
