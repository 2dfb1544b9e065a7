"""Primitive layers (PyTorch counterparts of ``repro.models.layers``).

Parameters are nested dicts of tensors with the JAX package's layouts:
a dense kernel is ``[in, out]``. Every layer provides ``*_init(gen, ...)``
drawing the same distributions as the reference, and a plain apply
function. Weights are cast to the activation dtype at apply time.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a ``torch.Generator`` where only shapes are wanted:
    every init draw from it is an empty tensor on the ``meta`` device
    (``launch.steps.abstract_params``); nothing is drawn."""

    device = torch.device("meta")


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype):
    """N(0, scale^2) drawn in float32 on the generator's device, then
    stored in ``dtype``."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, bias: bool = False,
               scale: Optional[float] = None, dtype=torch.float32):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    p = {"kernel": normal(gen, (in_dim, out_dim), scale, dtype)}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=gen.device)
    return p


def dense_apply(p, x):
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def embedding_init(gen, vocab: int, dim: int, dtype=torch.float32):
    return {"embedding": normal(gen, (vocab, dim), 1.0 / math.sqrt(dim),
                                dtype)}


def embedding_apply(p, tokens, dtype=torch.bfloat16):
    return p["embedding"][tokens.long()].to(dtype)


def embedding_attend(p, x):
    """Tied readout: logits = x @ E^T (computed in float32)."""
    return x.float() @ p["embedding"].float().T


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, device, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps: float = 1e-5):
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                      # [hd/2]


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. Split-halves
    layout: the first and second halves of head_dim form the pairs."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs       # [...,S,hd/2]
    angles = angles[..., None, :]                          # [...,S,1,hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP (gate/up/down)
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, ffn_dim: int, dtype=torch.float32):
    return {
        "gate": dense_init(gen, d_model, ffn_dim, dtype=dtype),
        "up": dense_init(gen, d_model, ffn_dim, dtype=dtype),
        "down": dense_init(gen, ffn_dim, d_model, dtype=dtype),
    }


def mlp_apply(p, x):
    g = dense_apply(p["gate"], x)
    u = dense_apply(p["up"], x)
    return dense_apply(p["down"], F.silu(g) * u)


# ---------------------------------------------------------------------------
# causal depthwise conv1d (used by the xLSTM blocks)
# ---------------------------------------------------------------------------

def conv1d_init(gen, dim: int, width: int, dtype=torch.float32):
    return {"kernel": normal(gen, (width, dim), 1.0 / math.sqrt(width), dtype),
            "bias": torch.zeros((dim,), dtype=dtype, device=gen.device)}


def conv1d_apply(p, x, state=None):
    """Causal depthwise conv. x: [B, S, D]. ``state``: [B, width-1, D] tail
    of the previous segment (decode); returns (y, new_state). Compute runs
    in x.dtype; new_state keeps the incoming state's dtype."""
    w = p["kernel"].to(x.dtype)                            # [W, D]
    width = w.shape[0]
    if state is None:
        state = torch.zeros(x.shape[:-2] + (width - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=-2)
    S = x.shape[-2]
    ys = xp[..., 0:S, :] * w[0]
    for i in range(1, width):
        ys = ys + xp[..., i:i + S, :] * w[i]
    new_state = (xp[..., -(width - 1):, :].to(state.dtype)
                 if width > 1 else state)
    return ys + p["bias"].to(x.dtype), new_state
