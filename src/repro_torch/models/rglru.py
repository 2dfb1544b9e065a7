"""RecurrentGemma recurrent block: the RG-LRU gated linear recurrence
behind a causal conv1d (PyTorch counterpart of ``repro.models.rglru``;
arXiv:2402.19427).

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates are computed in f32 for the whole segment, and the recurrence
runs through the ``rg_lru_scan`` op: the hand-written kernel on the card,
its plain version on the CPU. The state (``h`` and the conv tail) is the
layer's decode cache and stays f32 whatever the model's dtype.

Routing differs from the reference in one deliberate place, as the mLSTM
path does: the reference's model calls ``rglru_apply`` without
``use_kernel`` (a ``jax.lax.associative_scan``) and ``rglru_step`` as a
plain update, while the port runs both through the scan op (S = 1 at
decode). The function is the same; the tests hold the port against both
of the reference's routes. The family trains: under autograd the op takes
``RGLRUScanFunction``, whose backward is the same scan run in reverse
time (``csrc/rg_lru_bwd.cu`` on the card, its plain version on the CPU);
the tests hold the gradients against ``jax.grad`` of the reference's
``associative_scan``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rg_lru.ops import rg_lru_scan
from repro_torch.models.layers import (conv1d_apply, conv1d_init,
                                       dense_apply, dense_init)

_C = 8.0  # RG-LRU exponent constant from the paper


def rglru_init(gen, cfg: ModelConfig, dtype=torch.float32):
    """``lam`` is drawn so that a = sigmoid(lam)^c lies in [0.9, 0.999],
    and stays f32 (W values) whatever ``dtype``: the gates read it in
    f32, as the reference's f32 parameters do."""
    M = cfg.d_model
    W = cfg.recurrent.lru_width or M
    u = torch.empty((W,), dtype=torch.float32, device=gen.device)
    if u.device.type != "meta":          # a MetaGenerator draws nothing
        u.uniform_(0.9, 0.999, generator=gen)
    root = u ** (1.0 / _C)
    lam = torch.log(root / (1.0 - root))
    return {
        "in_x": dense_init(gen, M, W, dtype=dtype),
        "in_gate": dense_init(gen, M, W, dtype=dtype),
        "conv": conv1d_init(gen, W, cfg.recurrent.conv1d_width, dtype),
        "w_a": dense_init(gen, W, W, dtype=dtype),    # recurrence gate r_t
        "w_i": dense_init(gen, W, W, dtype=dtype),    # input gate i_t
        "lam": lam,
        "out": dense_init(gen, W, M, dtype=dtype),
    }


def rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                device=None):
    W = cfg.recurrent.lru_width or cfg.d_model
    cw = cfg.recurrent.conv1d_width
    return {
        "h": torch.zeros((batch, W), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cw - 1, W), dtype=dtype, device=device),
    }


def _gates(params, xw, lo: int = 0, hi: int = None):
    """a_t and the gated input b_t, both f32, of channels [lo, hi) (the
    ``w_a``/``w_i`` columns given; all by default); xw: [B,S,W] conv
    output."""
    r = torch.sigmoid(dense_apply(params["w_a"], xw).float())
    i = torch.sigmoid(dense_apply(params["w_i"], xw).float())
    hi = xw.shape[-1] if hi is None else hi
    lam = params["lam"].float()
    if lam.shape[0] != hi - lo:
        lam = lam[lo:hi]
    log_a = -_C * r * F.softplus(-lam)              # log sigmoid^(c r)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (i * xw[..., lo:hi].float())
    return a, b


def rglru_apply(params, cfg: ModelConfig, x, state=None, tp=None):
    """Full-sequence block. x: [B,S,M] -> (y [B,S,M], final state).
    ``tp`` (a mesh's ``models.parallel.TensorParallel``): the rank holds
    its column block of ``in_x``, ``in_gate``, ``w_a`` and ``w_i``, its
    rows of ``out`` and its channels of ``h``; the conv runs over the
    gathered branch (its state is whole on every rank), the gates and the
    scan over the rank's channels, and ``out`` sums over the axis."""
    if state is None:
        state = rglru_state(cfg, x.shape[0], device=x.device)
    W = cfg.recurrent.lru_width or cfg.d_model
    split = tp is not None and params["in_x"]["kernel"].shape[1] != W
    branch_x = dense_apply(params["in_x"], x)
    if split:
        branch_x = tp.gather_last(branch_x)
    # jax.nn.gelu's default is the tanh approximation
    gate = F.gelu(dense_apply(params["in_gate"], x), approximate="tanh")
    xc, conv_state = conv1d_apply(params["conv"], branch_x, state["conv"])
    lo, hi = tp.block(W) if split else (0, W)
    a, b = _gates(params, xc, lo, hi)               # [B,S,W] each, f32
    hs, h_last = rg_lru_scan(a, b, state["h"].float())
    if tp is None:
        y = dense_apply(params["out"], hs.to(x.dtype) * gate)
    else:
        from repro_torch.models.parallel import row_parallel
        y = row_parallel(params["out"], hs.to(x.dtype) * gate, W, tp)
    return y, {"h": h_last, "conv": conv_state}


def rglru_step(params, cfg: ModelConfig, x, state, tp=None):
    """Single-token decode, x: [B,1,M]: the full-sequence block at S = 1
    (one scan launch)."""
    return rglru_apply(params, cfg, x, state, tp)


def rglru_block_pattern(cfg: ModelConfig):
    """RecurrentGemma interleave: (rec, rec, attn) repeating (1:2)."""
    pat = (cfg.recurrent.block_pattern if cfg.recurrent
           and cfg.recurrent.block_pattern else ("rec", "rec", "attn"))
    return tuple(pat[i % len(pat)] for i in range(cfg.num_layers))
