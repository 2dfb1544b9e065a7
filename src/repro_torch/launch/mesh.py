"""Meshes of the port (the counterpart of ``repro.launch.mesh``): a
``torch.distributed`` ``DeviceMesh`` with the reference's axis names.

``make_host_mesh`` lays a ("data", "model") mesh over the default
process group's ranks, which the caller starts (``init_process_group``
with its own address, world size and rank). The production meshes of
256 and 512 chips (``make_production_mesh``) are not ported: they wait
for the dry-run's counterpart (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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


__all__ = ["make_host_mesh"]
