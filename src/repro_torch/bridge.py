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
