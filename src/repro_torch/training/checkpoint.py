"""Checkpoints in the reference's format (``repro.training.checkpoint``):
``arrays.npz`` holding ``leaf_{i}`` in ``jax.tree.flatten``'s order
(``training.tree``), bfloat16 stored as its uint16 bits, and ``meta.json``
holding ``step``, ``n_leaves`` and each leaf's dtype name. A checkpoint
written by either package loads in the other. The uint16 bits are read
back as ``torch.bfloat16`` (no ``ml_dtypes``)."""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.training.tree import tree_leaves, tree_unflatten


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def save_checkpoint(path: str, tree: Any, step: int = 0):
    os.makedirs(path, exist_ok=True)
    arrays, dtypes = {}, []
    leaves = tree_leaves(tree)
    for i, x in enumerate(leaves):
        arrays[f"leaf_{i}"], dt = _to_numpy(torch.as_tensor(x))
        dtypes.append(dt)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves), "dtypes": dtypes},
                  f)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf a tensor of the
    shape, dtype and device of ``like``'s leaf (a shape that differs
    raises)."""
    data = np.load(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    leaves = tree_leaves(like)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint holds {meta['n_leaves']} leaves, the "
                         f"tree {len(leaves)}")
    new = []
    for i, ref in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if meta.get("dtypes") and meta["dtypes"][i] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(t.shape)}, "
                             f"tree {tuple(ref.shape)}")
        new.append(t.to(device=ref.device, dtype=ref.dtype))
    return tree_unflatten(like, new), meta["step"]
