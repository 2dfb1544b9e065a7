"""The port's partition specs (``repro_torch.sharding.partition``, a copy
of ``repro.sharding.partition``'s spec logic) against the reference's on
the same ``jax.sharding.AbstractMesh`` (both read only its axis sizes):
``params_pspecs`` of every architecture's full and smoke parameter tree
at the train and inference FSDP thresholds, ``batch_pspec`` and
``cache_pspecs`` of every decode shape, ``params_shardings`` of every
smoke tree (placements against the reference's ``NamedSharding``s), on
("data", "model") meshes of
(2, 2) and (16, 16) (experts padded to the model axis, as both
``make_model``s pad them). Specs compare entry for entry, in the
trees' leaf order (which is ``jax.tree.flatten``'s in both packages).

Then the DTensor side on four gloo ranks at (2, 2): ``placements`` of
each spec, ``distribute_params`` of a whole smoke tree against
``distribute_tensor`` shard for shard, and ``gather_shards`` (the sharded
train step's gather) against ``DTensor.full_tensor``, its gradient
against DTensor's with partial gradients (exact: sums of the same
values)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.sharding import partition as part  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402
from torch.distributed.tensor import Replicate  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"2x2": AbstractMesh((2, 2), ("data", "model")),
          "16x16": AbstractMesh((16, 16), ("data", "model"))}
THRESHOLDS = (8 * 1024 * 1024, 64 * 1024 * 1024)


def _ref_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree):
    return [tuple(s) for s in tree_leaves(tree, part.PSpec)]


def _trees(arch, smoke, mesh):
    jcfg = (jget_smoke if smoke else jget_config)(arch)
    cfg = (get_smoke_config if smoke else get_config)(arch)
    jmodel = jsteps.make_model(jcfg, mesh, scan_layers=False)
    ref = jsteps.abstract_params(jmodel)
    port = steps.abstract_params(Model(
        cfg, dtype=torch.float32, device="meta",
        num_experts_padded=steps.experts_padded(cfg, mesh)))
    return jcfg, cfg, ref, port


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_pspecs_match_reference(arch, smoke, mesh_name):
    mesh = MESHES[mesh_name]
    jcfg, cfg, ref, port = _trees(arch, smoke, mesh)
    for thr in THRESHOLDS:
        want = _ref_specs(jpart.params_pspecs(ref, jcfg, mesh=mesh,
                                              fsdp_threshold_elems=thr))
        got = _port_specs(part.params_pspecs(port, cfg, mesh=mesh,
                                             fsdp_threshold_elems=thr))
        assert got == want
    # the expert stacks shard over the model axis when they divide it
    if cfg.is_moe:
        specs = part.params_pspecs(port, cfg, mesh=mesh)
        moe = next(layer["moe"] for layer in specs["layers"]
                   if "moe" in layer)
        assert moe["experts"]["gate"][0] == "model"


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_shardings_match_reference(arch):
    """``params_shardings`` of every smoke parameter tree on the (2, 2)
    mesh: each leaf's placements are the reference's ``NamedSharding``
    spec for it mapped through ``placements``."""
    mesh = MESHES["2x2"]
    jcfg, cfg, ref, port = _trees(arch, True, mesh)
    want = [part.placements(part.PSpec(*s.spec), mesh) for s in
            jax.tree.leaves(jpart.params_shardings(ref, jcfg, mesh))]
    got = tree_leaves(part.params_shardings(port, cfg, mesh), tuple)
    assert len(got) == len(want) and got == want
    assert any(p != (Replicate(), Replicate()) for p in got)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_pspecs_match_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        jcfg = jsteps.adapt_for_shape(jget_config(arch), JSHAPES[shape_name])
        cfg = steps.adapt_for_shape(get_config(arch), shape)
        jm = jsteps.make_model(jcfg, None, scan_layers=False)
        ref = jsteps.decode_cache_specs(jm, jcfg, JSHAPES[shape_name], None)
        port = steps.decode_cache_specs(
            steps.make_model(cfg, device="meta"), cfg, shape)
        want = _ref_specs(jpart.cache_pspecs(ref, jcfg, mesh,
                                             shape.global_batch))
        got = _port_specs(part.cache_pspecs(port, cfg, mesh,
                                            shape.global_batch))
        assert got == want, shape_name


def test_batch_pspec_and_sanitize_match_reference():
    meshes = list(MESHES.values()) + [
        AbstractMesh((2, 16, 16), ("pod", "data", "model")),
        AbstractMesh((1, 2), ("data", "model"))]
    for mesh in meshes:
        for batch in (1, 2, 4, 16, 32, 128, 256, 3):
            assert tuple(part.batch_pspec(batch, mesh)) == \
                tuple(jpart.batch_pspec(batch, mesh))
    P = jax.sharding.PartitionSpec
    mesh = MESHES["16x16"]
    for spec, shape in [((("model", None)), (49155, 64)),
                        ((("model", None)), (49152, 64)),
                        (((("data", "model"), None)), (512, 8)),
                        (((("data", "model"), None)), (128, 8))]:
        assert tuple(part.sanitize_spec(part.PSpec(*spec), shape, mesh)) \
            == tuple(jpart.sanitize_spec(P(*spec), shape, mesh))
    for spec, shape in [((None, "model"), (1024, 1024)),
                        ((None, "model"), (16384, 53248))]:
        assert tuple(part.apply_fsdp(part.PSpec(*spec), shape, mesh)) \
            == tuple(jpart.apply_fsdp(P(*spec), shape, mesh))


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x2"]
    assert part.placements(part.PSpec(None, "model"), mesh) == \
        (Replicate(), Shard(1))
    assert part.placements(part.PSpec("model", "data", None), mesh) == \
        (Shard(1), Shard(0))
    assert part.placements(part.PSpec(("data", "model"), None), mesh) == \
        (Shard(0), Shard(0))
    assert part.placements(part.PSpec(None, None), mesh) == \
        (Replicate(), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        part.placements(part.PSpec(("model", "data")), mesh)


_RANK = r"""
import sys, dataclasses
import torch
import torch.distributed as dist
from torch.distributed.tensor import Partial, distribute_tensor
d, rank = sys.argv[1], int(sys.argv[2])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                        world_size=4)
from repro_torch import generator_for
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import Model
from repro_torch.sharding import partition as part
from repro_torch.training.tree import tree_leaves, tree_paths

mesh = make_host_mesh(model=2)
cfg = get_smoke_config("qwen2-moe-a2.7b")
full = Model(cfg, dtype=torch.float32, device="cpu").init(
    generator_for(torch.device("cpu"), 0))
# a threshold of 1024 elements makes FSDP shard most leaves over "data"
specs = part.params_pspecs(full, cfg, mesh=mesh, fsdp_threshold_elems=1024)
dts = part.distribute_params(full, part.tree_placements(specs, mesh),
                             mesh)
n_data = 0
for (names, x), s, dt in zip(tree_paths(full), tree_leaves(specs, part.PSpec),
                             tree_leaves(dts)):
    pl = part.placements(s, mesh)
    assert dt.placements == pl, (names, dt.placements, pl)
    n_data += pl[0].is_shard()
    ref = distribute_tensor(x, mesh, pl)
    assert torch.equal(dt.to_local(), ref.to_local()), names
    local = dt.to_local().detach().requires_grad_()
    keep = 1 if "experts" in names else None
    got = part.gather_shards(local, mesh, pl, keep)
    if keep is None:
        assert torch.equal(got, x), names
    else:
        lo = mesh.get_coordinate()[1] * got.shape[0]
        assert torch.equal(got, x[lo:lo + got.shape[0]]), names
    w = torch.full_like(got, float(rank + 1))
    (g,) = torch.autograd.grad((got * w).sum(), [local])
    leaf = ref.detach().requires_grad_()
    if keep is None:
        whole = leaf.full_tensor(grad_placements=[Partial(), Partial()])
        (whole * torch.full_like(whole, float(rank + 1))).sum().backward()
    else:
        from torch.distributed.tensor import Replicate
        mine = leaf.redistribute(mesh, [Replicate(), pl[1]]).to_local(
            grad_placements=[Partial(), pl[1]])
        (mine * torch.full_like(mine, float(rank + 1))).sum().backward()
    assert torch.equal(g, leaf.grad.to_local()), names
assert n_data > 0
print("ok", rank, n_data)
dist.destroy_process_group()
"""


def test_distribute_and_gather_on_four_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(tmp_path),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0 and "ok" in out, out
