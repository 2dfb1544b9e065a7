"""A configuration file's served model: the ``ModelConfig`` the program
takes, and its weights drawn from the run's seed.

The weights are the benchmark's own: one buffer in the served dtype is
filled by a single ``normal_`` draw from a ``torch.Generator`` on the
weights' device, then cut into the parameter tree ``ServingEngine(params=)``
takes (each tensor a contiguous view, 256-byte aligned) and scaled in
place. The same tensors go to the engine and to the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: every tensor starts at a multiple of this many elements
ALIGN = 128


def model_config(served: Dict[str, Any]):
    """The program's ``ModelConfig`` of a configuration's ``served``
    section."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in served.items() if k in fields and k != "moe"}
    return ModelConfig(moe=MoEConfig(**served["moe"]), **kw)


def reference_config(served: Dict[str, Any]) -> Dict[str, Any]:
    """The plain dict the reference models read."""
    return {k: served[k] for k in ("num_heads", "num_kv_heads", "head_dim",
                                   "norm_eps", "rope_theta", "moe")}


def param_specs(served: Dict[str, Any]) -> List[Tuple[Tuple, Tuple, str,
                                                      float]]:
    """(path in the tree, shape, kind, scale) of every parameter, in
    draw order. kind "normal": N(0, scale^2); "norm": 1 + scale N(0, 1)."""
    M, V = served["d_model"], served["vocab_size"]
    H, Kv, D = served["num_heads"], served["num_kv_heads"], served["head_dim"]
    m = served["moe"]
    E, F = m["num_experts"], m["expert_ffn_dim"]
    specs = [(("embed", "embedding"), (V, M), "normal", M ** -0.5),
             (("final_norm", "scale"), (M,), "norm", 0.1),
             (("lm_head", "kernel"), (M, V), "normal", M ** -0.5)]
    for i in range(served["num_layers"]):
        L = ("layers", i)

        def dense(name, fan_in, fan_out, *where):
            specs.append((L + where + (name, "kernel"), (fan_in, fan_out),
                          "normal", fan_in ** -0.5))
        specs.append((L + ("ln1", "scale"), (M,), "norm", 0.1))
        if served["attention"] == "mla":
            r = served["mla_kv_lora_rank"]
            dense("wq", M, H * D, "attn")
            dense("w_dkv", M, r, "attn")
            dense("w_ukv", r, H * 2 * D, "attn")
            dense("w_kpe", M, D, "attn")
        else:
            dense("wq", M, H * D, "attn")
            dense("wk", M, Kv * D, "attn")
            dense("wv", M, Kv * D, "attn")
        dense("wo", H * D, M, "attn")
        specs.append((L + ("ln2", "scale"), (M,), "norm", 0.1))
        dense("router", M, E, "moe")
        for name, shape, fan_in in (("gate", (E, M, F), M),
                                    ("up", (E, M, F), M),
                                    ("down", (E, F, M), F)):
            specs.append((L + ("moe", "experts", name), shape, "normal",
                          fan_in ** -0.5))
        if m["num_shared_experts"]:
            S = m["num_shared_experts"] * m["shared_ffn_dim"]
            dense("gate", M, S, "moe", "shared")
            dense("up", M, S, "moe", "shared")
            dense("down", S, M, "moe", "shared")
    return specs


def _put(tree, path, value) -> None:
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(tree) <= key:
                tree.append({})
            tree = tree[key]
        else:
            tree = tree.setdefault(key, [] if isinstance(nxt, int) else {})
    tree[path[-1]] = value


def draw_params(served: Dict[str, Any], seed: int,
                device: torch.device) -> Dict[str, Any]:
    """The served model's weights from ``seed``, in the served dtype on
    ``device``."""
    dtype = DTYPES[served["dtype"]]
    specs = param_specs(served)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // ALIGN) * ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    tree: Dict[str, Any] = {}
    for (path, shape, kind, scale), off, n in zip(specs, offsets, sizes):
        t = flat[off:off + n].view(shape)
        if kind == "norm":
            t.mul_(scale).add_(1.0)
        else:
            t.mul_(scale)
        _put(tree, path, t)
    return tree
