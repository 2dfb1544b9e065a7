"""The sharded train step (``launch.steps.build(cfg, shape, mesh=...)``,
DEP under autograd) on gloo CPU ranks, held against the reference's
sharded ``train_step`` (its ``build`` on a plain ``jax.sharding.Mesh``
of forced host devices, jitted with the bundle's shardings) at the same
("data", "model") layouts, (1, 2) and (2, 2), on the same weights and
global batch: the smoke qwen2-moe-a2.7b at capacity factor 4 (nothing
dropped), f32, two steps.

Checked per layout: the bundle's placements against the reference
bundle's ``in_shardings`` and each rank's batch rows against its
device's; the first step's loss and every leaf's gradient
(relative L2, 1e-5: the two differ only by f32 summation order, 1.2e-6
measured; the absolute 1e-7 term per element keeps a leaf whose
gradient cancels to near zero from dividing by nothing), both steps'
loss and grad norm (1e-5), and every parameter's update over the two
AdamW steps at lr 1e-3 (relative L2 1e-3, 4.3e-4 measured: AdamW divides
by sqrt(v), which magnifies the rounding of near-zero gradient
elements).

Controls: the reverse exchange of the DEP walk skipped (the gradient of
a received chunk kept as the sent chunk's) must miss the gradient limit
(0.52 measured); and the reference's own unsharded gradients must miss
it against its sharded ones (the aux loss is a device mean of per-rank
losses, so the two differ at 1e-4), which shows the limit sees the
layout.

The reference runs in one subprocess and the eight ranks in eight more, all
at once; training tests keep torch at one intra-op thread."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LAYOUTS = ((1, 2), (2, 2))
B, S = 4, 16
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
LOSS_TOL = 1e-5
UPDATE_TOL = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_COMMON = r"""
import dataclasses, sys
import numpy as np

d = sys.argv[1]
inputs = np.load(f"{d}/inputs.npz")
N = int(inputs["n_leaves"])
LEAVES = [inputs[f"leaf_{i}"] for i in range(N)]
TOKENS = inputs["tokens"]
B, S = TOKENS.shape
"""

_GOLDEN = _COMMON + r"""
import json
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeConfig
from repro.launch import steps
from repro.training.optimizer import AdamWConfig, init_opt_state

cfg = get_smoke_config("qwen2-moe-a2.7b")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                       capacity_factor=4.0))
shape = ShapeConfig("train_smoke", S, B, "train")
opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, state_dtype=jnp.float32)
tok = jnp.asarray(TOKENS)
out = {}


def _dims(spec, ndim):
    ent = tuple(spec) + (None,) * (ndim - len(spec))
    return [[] if e is None else [e] if isinstance(e, str) else list(e)
            for e in ent]


one = steps.make_model(cfg, None, scan_layers=False, dtype=jnp.float32)
like = jax.eval_shape(one.init, jax.random.PRNGKey(0))
params = jax.tree.unflatten(jax.tree.structure(like),
                            [jnp.asarray(x) for x in LEAVES])
_, g = jax.jit(jax.value_and_grad(lambda p: one.loss(p, tok)))(params)
for i, x in enumerate(jax.tree.leaves(g)):
    out[f"1x1-grad-{i}"] = x
for layout in [(1, 2), (2, 2)]:
    n = layout[0] * layout[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(layout),
                ("data", "model"))
    b = steps.build(cfg, shape, mesh=mesh, dtype=jnp.float32,
                    scan_layers=False, opt_cfg=opt_cfg)
    like = jax.eval_shape(b.model.init, jax.random.PRNGKey(0))
    params = jax.tree.unflatten(jax.tree.structure(like),
                                [jnp.asarray(x) for x in LEAVES])
    tag = f"{layout[0]}x{layout[1]}"
    # the layout: each leaf's spec and the tokens', per tensor dim the
    # mesh axes it is split over; and each device's first token row
    lay = [_dims(sh.spec, a.ndim) for sh, a in zip(
        jax.tree.leaves(b.in_shardings[0]), jax.tree.leaves(like))]
    lay.append(_dims(b.in_shardings[2].spec, 2))
    out[f"{tag}-layout"] = np.array(json.dumps(lay))
    rows = {sh.device.id: sh.index[0].start or 0 for sh in
            jax.device_put(tok, b.in_shardings[2]).addressable_shards}
    out[f"{tag}-rows"] = np.array([rows[dv.id] for dv in
                                   mesh.devices.reshape(-1)])
    with mesh:
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: b.model.loss(p, tok)))(params)
        out[f"{tag}-grad-loss"] = loss
        for i, x in enumerate(jax.tree.leaves(g)):
            out[f"{tag}-grad-{i}"] = x
        fn = jax.jit(b.step_fn, in_shardings=b.in_shardings,
                     out_shardings=b.out_shardings)
        p, o = params, init_opt_state(params, opt_cfg)
        for step in range(2):
            p, o, m = fn(p, o, tok)
            out[f"{tag}-loss-{step}"] = m["loss"]
            out[f"{tag}-gnorm-{step}"] = m["grad_norm"]
        for i, x in enumerate(jax.tree.leaves(p)):
            out[f"{tag}-param-{i}"] = x
np.savez(f"{d}/golden.npz", **{k: np.asarray(v) for k, v in out.items()})
"""

_RANK = _COMMON + r"""
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard, distribute_tensor

torch.set_num_threads(1)
rank, dp, mo, control = (int(sys.argv[2]), int(sys.argv[3]),
                         int(sys.argv[4]), sys.argv[5])
tag = f"{dp}x{mo}"
dist.init_process_group("gloo", init_method=f"file://{d}/store-{tag}-{control}",
                        rank=rank, world_size=dp * mo)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import dep
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.partition import distribute_params
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.tree import tree_leaves, tree_unflatten

cfg = get_smoke_config("qwen2-moe-a2.7b")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                       capacity_factor=4.0))
shape = ShapeConfig("train_smoke", S, B, "train")
opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, state_dtype=torch.float32)
if control == "skip":        # the reverse exchange skipped
    dep.reverse_exchange = lambda grad, shp, group: grad.reshape(shp)
mesh = make_host_mesh(model=mo, data=dp)
b = steps.build(cfg, shape, mesh=mesh, dtype=torch.float32, device="cpu",
                opt_cfg=opt_cfg)
full = tree_unflatten(b.abstract_args[0],
                      [torch.from_numpy(x) for x in LEAVES])
params = distribute_params(full, b.placements[0], mesh)
tok = torch.from_numpy(TOKENS)
out = {}
# the bundle's layout, per tensor dim the mesh axes it is split over,
# and the first global row of this rank's shard_batch (every rank's)
names = mesh.mesh_dim_names
lay = [[[names[i] for i, p in enumerate(pl)
         if isinstance(p, Shard) and p.dim == dim] for dim in range(a.ndim)]
       for pl, a in zip(tree_leaves(b.placements[0], tuple),
                        tree_leaves(b.abstract_args[0]))]
lay.append([[names[i] for i, p in enumerate(b.placements[2])
             if isinstance(p, Shard) and p.dim == dim] for dim in range(2)])
out["layout"] = np.array(json.dumps(lay))
row_ids = torch.arange(B)[:, None].repeat(1, S)
by_placements = distribute_tensor(tok, mesh, b.placements[2]).to_local()
first = torch.tensor([int(steps.shard_batch(row_ids, mesh)[0, 0]),
                      int(torch.equal(steps.shard_batch(tok, mesh),
                                      by_placements))])
allf = [torch.zeros_like(first) for _ in range(dp * mo)]
dist.all_gather(allf, first)
out["rows"] = np.array([int(f[0]) for f in allf])
out["rows-as-placed"] = np.array(min(int(f[1]) for f in allf))
loss, grads = steps.sharded_loss_and_grads(
    b.model, params, mesh, steps.shard_batch(tok, mesh))
out["grad-loss"] = loss.numpy()
for i, g in enumerate(tree_leaves(grads)):
    out[f"grad-{i}"] = g.full_tensor().numpy()
opt = init_opt_state(params, opt_cfg)
for step in range(2):
    params, opt, m = b.step_fn(params, opt, tok)
    out[f"loss-{step}"] = m["loss"].numpy()
    out[f"gnorm-{step}"] = m["grad_norm"].numpy()
for i, p in enumerate(tree_leaves(params)):
    out[f"param-{i}"] = p.full_tensor().numpy()
if rank == 0:
    np.savez(f"{d}/port-{tag}-{control}.npz", **out)
dist.destroy_process_group()
"""


def _run(tmp_path):
    """Writes the inputs, runs the reference and every rank at once, and
    returns (golden, {(layout, control): port})."""
    cfg = jax_smoke("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    model = jsteps.make_model(cfg, None, scan_layers=False,
                              dtype=jnp.float32)
    leaves = [np.asarray(x) for x in
              jax.tree.leaves(model.init(jax.random.PRNGKey(0)))]
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    np.savez(tmp_path / "inputs.npz", tokens=tokens, n_leaves=len(leaves),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _GOLDEN,
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    runs = [((1, 2), "none"), ((2, 2), "none"), ((1, 2), "skip")]
    for (dp, mo), control in runs:
        for r in range(dp * mo):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK, str(tmp_path), str(r),
                 str(dp), str(mo), control], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out
    golden = dict(np.load(tmp_path / "golden.npz"))
    port = {(layout, control): dict(np.load(
        tmp_path / f"port-{layout[0]}x{layout[1]}-{control}.npz"))
        for layout, control in runs}
    return golden, port, leaves


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("sharded_train"))


def _grad_errors(golden, port, tag, n, ref_tag=None):
    """Per leaf: ||port - ref|| / (||ref|| + atol-scaled), the worst."""
    worst = 0.0
    for i in range(n):
        ref = golden[f"{ref_tag or tag}-grad-{i}"]
        got = port[f"grad-{i}"] if port is not None \
            else golden[f"{tag}-grad-{i}"]
        err = np.linalg.norm(got - ref) / (
            np.linalg.norm(ref) + GRAD_ATOL / GRAD_RTOL * np.sqrt(ref.size))
        worst = max(worst, float(err))
    return worst


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_sharded_step_grads_match_reference(results, layout):
    golden, port, leaves = results
    n = len(leaves)
    tag = f"{layout[0]}x{layout[1]}"
    got = port[(layout, "none")]
    np.testing.assert_allclose(got["grad-loss"], golden[f"{tag}-grad-loss"],
                               rtol=LOSS_TOL)
    assert _grad_errors(golden, got, tag, n) < GRAD_RTOL
    for i in range(n):     # every leaf reached: finite and non-zero
        g = got[f"grad-{i}"]
        assert np.isfinite(g).all() and np.abs(g).max() > 0, i


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_sharded_two_steps_match_reference(results, layout):
    golden, port, leaves = results
    tag = f"{layout[0]}x{layout[1]}"
    got = port[(layout, "none")]
    for step in range(2):
        np.testing.assert_allclose(got[f"loss-{step}"],
                                   golden[f"{tag}-loss-{step}"],
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(got[f"gnorm-{step}"],
                                   golden[f"{tag}-gnorm-{step}"],
                                   rtol=LOSS_TOL)
    for i, p0 in enumerate(leaves):
        ref = golden[f"{tag}-param-{i}"] - p0
        err = np.linalg.norm(got[f"param-{i}"] - p0 - ref) \
            / np.linalg.norm(ref)
        assert err < UPDATE_TOL, (i, err)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_bundle_placements_match_reference_shardings(results, layout):
    """The sharded bundle's placements (parameters and tokens) against the
    reference bundle's ``in_shardings``, per tensor dim the mesh axes it
    is split over; ``shard_batch`` gives each rank the rows the
    reference's token sharding gives its device, and the rows its
    placements give."""
    golden, port, _ = results
    tag = f"{layout[0]}x{layout[1]}"
    got = port[(layout, "none")]
    assert json.loads(str(got["layout"])) == \
        json.loads(str(golden[f"{tag}-layout"]))
    np.testing.assert_array_equal(got["rows"], golden[f"{tag}-rows"])
    assert int(got["rows-as-placed"]) == 1


def test_reverse_exchange_skipped_fails(results):
    golden, port, leaves = results
    assert _grad_errors(golden, port[((1, 2), "skip")], "1x2",
                        len(leaves)) > 10 * GRAD_RTOL


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_limit_sees_the_layout(results, layout):
    """The reference's unsharded gradients against its sharded ones."""
    golden, _, leaves = results
    assert _grad_errors(golden, None, f"{layout[0]}x{layout[1]}",
                        len(leaves), ref_tag="1x1") > GRAD_RTOL
