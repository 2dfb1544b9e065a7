"""Mixture-of-Experts layer (PyTorch counterpart of ``repro.models.moe``):
top-k router, routed experts with stacked weights, optional shared
experts.

Two execution paths:
  * ``moe_apply_dense``    — exact all-experts product (oracle / tiny models)
  * ``moe_apply_capacity`` — GShard-style capacity dispatch with drops.

Both run the routed experts through ``expert_ffn``, which is the grouped
SwiGLU kernel's wrapper (``kernels/moe_gemm``): on the card it launches the
hand-written CUDA kernel, on the CPU its plain version. The reference's
capacity path computes the same function with an einsum
(``repro/models/moe.py:88-94``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_gemm.ops import moe_gemm
from repro_torch.models.layers import (dense_apply, dense_init, mlp_apply,
                                       mlp_init, normal)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def moe_init(gen, d_model: int, mcfg: MoEConfig, num_experts_padded: int = 0,
             dtype=torch.float32):
    E = num_experts_padded or mcfg.num_experts
    H = mcfg.expert_ffn_dim
    scale = 1.0 / math.sqrt(d_model)
    params = {
        "router": dense_init(gen, d_model, E, scale=scale, dtype=dtype),
        "experts": {
            "gate": normal(gen, (E, d_model, H), scale, dtype),
            "up": normal(gen, (E, d_model, H), scale, dtype),
            "down": normal(gen, (E, H, d_model), 1.0 / math.sqrt(H), dtype),
        },
    }
    if mcfg.num_shared_experts > 0:
        shared_H = (mcfg.shared_ffn_dim or H) * mcfg.num_shared_experts
        params["shared"] = mlp_init(gen, d_model, shared_H, dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

class Routing(NamedTuple):
    weights: torch.Tensor    # [T, k]  combine weights (post-softmax, renorm)
    experts: torch.Tensor    # [T, k]  int64 expert ids
    probs: torch.Tensor      # [T, E]  full softmax (for aux loss)


def route_topk(router_params, x_flat, mcfg: MoEConfig,
               num_experts_padded: int = 0) -> Routing:
    """x_flat: [T, M] -> top-k routing per token, softmax in f32."""
    E_pad = num_experts_padded or mcfg.num_experts
    logits = dense_apply(router_params, x_flat).float()
    if E_pad > mcfg.num_experts:                  # mask padded experts
        logits[..., mcfg.num_experts:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, mcfg.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return Routing(weights=weights, experts=experts, probs=probs)


def load_balance_loss(routing: Routing, mcfg: MoEConfig) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e over real experts."""
    E = mcfg.num_experts
    probs = routing.probs[..., :E]
    onehot = F.one_hot(routing.experts, probs.shape[-1])[..., :E].float()
    f = onehot.sum(dim=(-3, -2)) / (routing.experts.shape[0] * mcfg.top_k)
    p = probs.mean(dim=0)
    return E * torch.sum(f * p)


# ---------------------------------------------------------------------------
# expert FFN
# ---------------------------------------------------------------------------

def expert_ffn(expert_params, x):
    """x: [E, C, M] -> [E, C, M]: one SwiGLU FFN per expert, through the
    grouped GEMM kernel's wrapper."""
    dt = x.dtype
    return moe_gemm(x.contiguous(), expert_params["gate"].to(dt),
                    expert_params["up"].to(dt), expert_params["down"].to(dt))


def shared_expert_apply(params, x):
    """Dense shared-expert path; fused over N_shared."""
    return mlp_apply(params["shared"], x)


class MoEStats(NamedTuple):
    """Per-layer routing telemetry: the [E] token-load histogram (logical
    expert ids, float32) and the count of capacity-overflow assignments
    that were dropped."""

    load: torch.Tensor        # [E] float32
    dropped: torch.Tensor     # []  int32


# ---------------------------------------------------------------------------
# execution path 1: exact dense combine (oracle)
# ---------------------------------------------------------------------------

def moe_apply_dense(params, x, mcfg: MoEConfig, num_experts_padded: int = 0,
                    return_stats: bool = False):
    """Every expert on every token, combined with the routing weights.
    Exact (no capacity drops). Returns (y, aux) or (y, aux, MoEStats)."""
    B, S, M = x.shape
    xf = x.reshape(-1, M)
    T = xf.shape[0]
    routing = route_topk(params["router"], xf, mcfg, num_experts_padded)
    E_pad = num_experts_padded or mcfg.num_experts
    cw = torch.zeros((T, E_pad), dtype=x.dtype, device=x.device)
    rows = torch.arange(T, device=x.device)[:, None].expand_as(
        routing.experts)
    cw.index_put_((rows, routing.experts), routing.weights.to(x.dtype),
                  accumulate=True)
    all_out = expert_ffn(params["experts"], xf.expand(E_pad, T, M))
    y = torch.einsum("te,etm->tm", cw, all_out)
    if "shared" in params:
        y = y + shared_expert_apply(params, xf)
    aux = load_balance_loss(routing, mcfg)
    y = y.reshape(B, S, M)
    if return_stats:
        load = F.one_hot(routing.experts, E_pad).float().sum(dim=(0, 1))
        zero = torch.zeros((), dtype=torch.int32, device=x.device)
        return y, aux, MoEStats(load=load, dropped=zero)
    return y, aux


# ---------------------------------------------------------------------------
# execution path 2: capacity-based dispatch (GShard)
# ---------------------------------------------------------------------------

class DispatchInfo(NamedTuple):
    buffers: torch.Tensor     # [E, C, M] dispatched tokens
    combine: torch.Tensor     # [T, k] combine weights (drops zeroed)
    slot: torch.Tensor        # [T, k] slot within expert buffer (C = drop)
    experts: torch.Tensor     # [T, k] expert (buffer row) ids
    aux: torch.Tensor
    load: torch.Tensor        # [E] token-assignment counts
    dropped: torch.Tensor     # []  capacity-overflow assignments (int32)


def expert_capacity(num_tokens: int, mcfg: MoEConfig,
                    num_experts_padded: int = 0, multiple_of: int = 1,
                    scale: float = 1.0) -> int:
    E = num_experts_padded or mcfg.num_experts
    cap = math.ceil(num_tokens * mcfg.top_k / E
                    * mcfg.capacity_factor * max(float(scale), 1.0))
    cap = max(cap, 1)
    return ((cap + multiple_of - 1) // multiple_of) * multiple_of


def moe_dispatch(params, xf, mcfg: MoEConfig, capacity: int,
                 num_experts_padded: int = 0) -> DispatchInfo:
    """Route and scatter tokens into per-expert buffers [E, C, M].

    Slots are assigned by a cumulative sum in TOKEN order (token t's k-th
    choice before token t+1's), so the kept and dropped assignments are
    exactly the reference's; an assignment past ``capacity`` goes to the
    scratch slot C, which is cut off."""
    T, M = xf.shape
    k = mcfg.top_k
    E_pad = num_experts_padded or mcfg.num_experts
    routing = route_topk(params["router"], xf, mcfg, num_experts_padded)
    experts = routing.experts
    flat = F.one_hot(experts.reshape(T * k), E_pad)            # [Tk, E]
    load = flat.sum(dim=0).float()                             # [E]
    pos = torch.cumsum(flat, dim=0) - flat
    slot = (pos * flat).sum(-1).reshape(T, k)                  # [T, k]
    keep = slot < capacity
    weights = torch.where(keep, routing.weights,
                          torch.zeros_like(routing.weights))
    slot_c = torch.where(keep, slot, torch.full_like(slot, capacity))
    dropped = (~keep).sum().to(torch.int32)
    buffers = torch.zeros((E_pad, capacity + 1, M), dtype=xf.dtype,
                          device=xf.device)
    # the JAX .at[].add: each kept (expert, slot) pair is written once;
    # only the scratch slot C accumulates, and it is discarded
    buffers.index_put_((experts.reshape(-1), slot_c.reshape(-1)),
                       xf.repeat_interleave(k, dim=0), accumulate=True)
    aux = load_balance_loss(routing, mcfg)
    return DispatchInfo(buffers=buffers[:, :capacity], combine=weights,
                        slot=slot_c, experts=experts, aux=aux, load=load,
                        dropped=dropped)


def moe_combine(info: DispatchInfo, expert_out: torch.Tensor, T: int,
                dtype) -> torch.Tensor:
    """Gather expert outputs back per token and apply combine weights."""
    E, C, M = expert_out.shape
    padded = torch.cat([expert_out, expert_out.new_zeros((E, 1, M))], dim=1)
    gathered = padded[info.experts.reshape(-1), info.slot.reshape(-1)]
    gathered = gathered.reshape(T, -1, M)
    return torch.einsum("tk,tkm->tm", info.combine.to(dtype),
                        gathered.to(dtype))


def moe_apply_capacity(params, x, mcfg: MoEConfig,
                       num_experts_padded: int = 0,
                       capacity: Optional[int] = None,
                       return_stats: bool = False):
    """Single-device capacity-based MoE layer. Returns (y, aux), or
    (y, aux, MoEStats) with ``return_stats``."""
    B, S, M = x.shape
    xf = x.reshape(-1, M)
    cap = capacity or expert_capacity(xf.shape[0], mcfg, num_experts_padded)
    info = moe_dispatch(params, xf, mcfg, cap, num_experts_padded)
    out = expert_ffn(params["experts"], info.buffers)
    y = moe_combine(info, out, xf.shape[0], x.dtype)
    if "shared" in params:
        y = y + shared_expert_apply(params, xf)
    y = y.reshape(B, S, M)
    if return_stats:
        return y, info.aux, MoEStats(load=info.load, dropped=info.dropped)
    return y, info.aux
