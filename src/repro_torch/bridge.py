"""Parameters from numpy: the JAX package's ``Model.init`` tree, converted
to numpy by the caller, becomes the port's parameter tree with the same
nesting. The port never sees JAX: the tests do the JAX-to-numpy step."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device="cpu",
                      dtype: torch.dtype = torch.float32) -> Any:
    """Map every array leaf of a nested dict/list/tuple tree to a tensor
    on ``device`` in ``dtype`` (float leaves; integer leaves keep their
    type). Containers keep their keys and order."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    t = torch.from_numpy(np.array(tree))          # a writable copy
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def shard_experts(params: Any, rank: int, mo: int) -> Any:
    """Expert rank ``rank``'s share of a converted parameter tree (the
    reference's ``shard_map`` in-spec ``P(axis)`` on the stacked experts,
    done by hand): every MoE layer keeps rows ``[rank·E/mo,
    (rank+1)·E/mo)`` of its stacked experts (copies); every other leaf is
    the same tensor, as the reference replicates it."""
    layers = []
    for layer in params["layers"]:
        experts = layer.get("moe", {}).get("experts")
        if experts is not None:
            E = next(iter(experts.values())).shape[0]
            if E % mo:
                raise ValueError(f"{E} experts do not divide over {mo} "
                                 "ranks")
            lo, hi = rank * (E // mo), (rank + 1) * (E // mo)
            layer = dict(layer, moe=dict(layer["moe"], experts={
                k: v[lo:hi].clone() for k, v in experts.items()}))
        layers.append(layer)
    return dict(params, layers=layers)
