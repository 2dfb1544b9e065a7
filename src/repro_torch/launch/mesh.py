"""Meshes of the port (the counterpart of ``repro.launch.mesh``): a
``torch.distributed`` ``DeviceMesh`` with the reference's axis names.

``make_host_mesh`` lays a ("data", "model") mesh over the default
process group's ranks, which the caller starts (``init_process_group``
with its own address, world size and rank). ``make_production_mesh``
lays the reference's production meshes of 256 and 512 cards over a fake
process group in this one process: the dry run (``launch.dryrun``) runs
rank 0's step on ``meta`` tensors, and the collectives of a fake group
move nothing.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) ("data", "model") = 256 cards. Multi-pod: (2,
    16, 16) ("pod", "data", "model") = 512 cards. The mesh lives on
    torch's ``"fake"`` process-group backend, whose collectives return at
    once and move nothing, so no check may read a value they produce:
    tensors on it are ``meta``. The fake group is initialised here when
    none exists (this process is rank 0) and replaced when a fake group of
    another size is live; a live group of another backend must have the
    mesh's size, else this raises. No card is touched."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized() and dist.get_world_size() != n:
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is live: the production "
                f"mesh needs {n}")
        dist.destroy_process_group()
    if not dist.is_initialized():
        # importing it registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(model: int = 1, data: int = 0, device_type=None):
    """A ("data", "model") ``DeviceMesh`` over every rank of the default
    process group: ``model`` ranks on the model (expert) axis, clipped to
    the world size as the reference clips it to the device count, and
    ``data`` (0: the world size over ``model``) on the data axis. Rank
    ``d * model + m`` sits at (d, m), the layout of
    ``core.dep.DepGroups.build``. ``device_type`` defaults to "cuda" under
    NCCL and to the CPU under gloo."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs the default process group "
                           "(init_process_group)")
    n = dist.get_world_size()
    model = max(1, min(model, n))
    data = data or n // model
    if data * model != n:
        raise ValueError(f"a {data} x {model} mesh over {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(data, model),
                      mesh_dim_names=("data", "model"))


__all__ = ["make_host_mesh", "make_production_mesh"]
