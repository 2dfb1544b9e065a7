"""AdamW with a cosine schedule (PyTorch counterpart of
``repro.training.optimizer``) over the port's parameter tree.

The reference's arithmetic, in float32 whatever the parameters' dtype:
the update is clipped by the gradients' global norm (``+ 1e-9``; the norm
returned is the one before the clip), bias correction uses the
incremented step, ``eps`` is added outside the square root, and weight
decay is decoupled and applied to leaves of two or more dimensions only.
States are kept in the parameter's dtype, or in ``state_dtype``.
``torch.optim.AdamW`` is not this function: it decays every leaf and has
no clip.

The parameters and states are updated in place (under
``torch.no_grad()``), so that a model at full width holds no second copy
of its weights; ``apply_updates`` still returns them, as the reference's
does.

A sharded tree (DTensor leaves, the sharded train step's) is updated
shard by shard on each rank, its states are DTensors with the same
placements, and ``global_norm`` is the norm of the whole tree: each
shard counts once, a leaf replicated over a mesh axis once, not once per
replica.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.training.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Optional[torch.dtype] = None   # None -> same as param


class OptState(NamedTuple):
    step: torch.Tensor       # int32 scalar on the parameters' device
    mu: Any
    nu: Any


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")

    def zeros_like(p):
        if isinstance(p, DTensor):
            local = p.to_local()
            return DTensor.from_local(
                torch.zeros(local.shape, dtype=cfg.state_dtype or p.dtype,
                            device=local.device),
                p.device_mesh, p.placements, run_check=False,
                shape=p.shape, stride=p.stride())
        return torch.zeros(p.shape, dtype=cfg.state_dtype or p.dtype,
                           device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(zeros_like, params),
                    nu=tree_map(zeros_like, params))


def schedule(cfg: AdamWConfig, step):
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_ratio`` x
    ``lr`` at ``total_steps`` (float32; ``step`` an int or a tensor)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio
                            + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of their float32 squares. For
    DTensor leaves the sum runs over the whole tree: each rank adds its
    shards' squares over the number of ranks holding the same shard (the
    mesh sizes of the leaf's ``Replicate`` dims), and the sums are added
    over the mesh."""
    plain, sharded, mesh = [], [], None
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            reps = 1
            for i, p in enumerate(x.placements):
                if p.is_replicate():
                    reps *= mesh.size(i)
            sharded.append(torch.sum(torch.square(x.to_local().float()))
                           / reps)
        else:
            plain.append(torch.sum(torch.square(x.float())))
    total = sum(plain)
    if sharded:
        part = torch.stack(sharded).sum()
        for i in range(mesh.ndim):
            if mesh.size(i) > 1:
                dist.all_reduce(part, group=mesh.get_group(i))
        total = total + part
    return torch.sqrt(total)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: AdamWConfig
                  ) -> Tuple[Any, OptState, torch.Tensor]:
    """One AdamW step, in place; returns (params, new state, grad_norm)."""
    flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
    flat_m, flat_v = tree_leaves(state.mu), tree_leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and states differ in structure")
    gnorm = global_norm(flat_g)
    flat_p, flat_g = [_local(x) for x in flat_p], [_local(x) for x in flat_g]
    flat_m, flat_v = [_local(x) for x in flat_m], [_local(x) for x in flat_v]
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.float() * scale
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * torch.square(g)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.dim() >= 2:      # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), gnorm
