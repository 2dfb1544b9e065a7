"""xLSTM blocks, sLSTM and mLSTM (PyTorch counterpart of
``repro.models.ssm``; arXiv:2405.04517).

Both blocks are recurrences: a full sequence runs the recurrence over
time, and decode is the same call on one token. The state is the decode
"cache" (an SSM layer has no KV cache). States are float32 whatever the
model's dtype, as in the reference.

Routing differs from the reference in one deliberate place: the
reference's ``apply_layer`` calls ``mlstm_apply`` with its default
``use_kernel=False`` (a ``lax.scan`` of the cell), while the port always
runs the recurrence through the ``mlstm_scan`` op — the hand-written
kernel on the card, its plain version on the CPU — for prefill and for
single-token decode alike. The function is the same, and the tests hold
the two routes against each other. The family trains: under autograd the
op takes ``MLSTMScanFunction``, whose backward is the hand-written
reverse scan (``csrc/mlstm_scan_bwd.cu``) on the card and its plain
version on the CPU; the tests hold the gradients against ``jax.grad`` of
the reference's ``lax.scan``. sLSTM has no kernel in the reference and
stays plain PyTorch: its scan is a Python loop over time, differentiated
by autograd.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.models.layers import (conv1d_apply, conv1d_init,
                                       dense_apply, dense_init, normal,
                                       rmsnorm_apply, rmsnorm_init)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen, cfg: ModelConfig, dtype=torch.float32):
    M = cfg.d_model
    H = cfg.num_heads
    d_inner = 2 * M
    return {
        "up": dense_init(gen, M, 2 * d_inner, dtype=dtype),   # -> (u, z)
        "conv": conv1d_init(gen, d_inner, 4, dtype),
        "wq": dense_init(gen, d_inner, d_inner, dtype=dtype),
        "wk": dense_init(gen, d_inner, d_inner, dtype=dtype),
        "wv": dense_init(gen, d_inner, d_inner, dtype=dtype),
        "w_if": dense_init(gen, d_inner, 2 * H, bias=True, dtype=dtype),
        "out_norm": rmsnorm_init(d_inner, gen.device, dtype),
        "down": dense_init(gen, d_inner, M, dtype=dtype),
        "skip": dense_init(gen, d_inner, d_inner, dtype=dtype),
    }


def mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                device=None):
    d_inner = 2 * cfg.d_model
    H = cfg.num_heads
    hd = d_inner // H
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, H, hd), dtype=dtype, device=device),
        "m": torch.full((batch, H), -1e30, dtype=dtype, device=device),
        "conv": torch.zeros((batch, 3, d_inner), dtype=dtype, device=device),
    }


def _mlstm_qkvif(params, cfg: ModelConfig, u_conv, u):
    """Project conv activations to per-head q,k,v and gates."""
    B, S, d_inner = u_conv.shape
    H = cfg.num_heads
    hd = d_inner // H
    q = dense_apply(params["wq"], u_conv).reshape(B, S, H, hd)
    k = dense_apply(params["wk"], u_conv).reshape(B, S, H, hd) / math.sqrt(hd)
    v = dense_apply(params["wv"], u).reshape(B, S, H, hd)
    gates = dense_apply(params["w_if"], u_conv).float()
    it, ft = gates[..., :H], gates[..., H:]
    return q, k, v, it, ft


def _heads_first(x):
    """[B, S, H, ...] -> contiguous f32 [B, H, S, ...]."""
    return x.transpose(1, 2).float().contiguous()


def mlstm_apply(params, cfg: ModelConfig, x, state=None,
                c_in_place: bool = False):
    """Full-sequence (or, with S = 1, decode) mLSTM block through the
    ``mlstm_scan`` op. x: [B,S,M] -> (y, final_state). ``c_in_place``
    writes the final matrix state over ``state["C"]`` (S below the scan's
    ``CHUNKWISE_MIN_S``), which the returned state then holds."""
    B, S, M = x.shape
    u, z = dense_apply(params["up"], x).chunk(2, dim=-1)
    if state is None:
        state = mlstm_state(cfg, B, device=x.device)
    u_conv, conv_state = conv1d_apply(params["conv"], F.silu(u),
                                      state["conv"])
    q, k, v, it, ft = _mlstm_qkvif(params, cfg, u_conv, u)
    log_f = F.logsigmoid(ft)                               # [B,S,H]
    h4, C, n, m = mlstm_scan(
        _heads_first(q), _heads_first(k), _heads_first(v),
        _heads_first(it), _heads_first(log_f),
        state["C"].contiguous(), state["n"].contiguous(),
        state["m"].contiguous(), c_in_place=c_in_place)
    final = {"C": C, "n": n, "m": m, "conv": conv_state}
    h = h4.transpose(1, 2).reshape(B, S, -1).to(x.dtype)   # [B,S,d_inner]
    h = rmsnorm_apply(params["out_norm"], h, cfg.norm_eps)
    h = h + dense_apply(params["skip"], u_conv)
    y = dense_apply(params["down"], h * F.silu(z))
    return y, final


def mlstm_step(params, cfg: ModelConfig, x, state):
    """Single-token decode, x: [B,1,M]. C is updated in place (8 slots of
    xlstm-1.3b hold 128 MiB of it per layer, which a captured decode step
    would otherwise copy back every step); n, m and the conv tail come
    back new."""
    return mlstm_apply(params, cfg, x, state, c_in_place=True)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen, cfg: ModelConfig, dtype=torch.float32):
    M = cfg.d_model
    H = cfg.num_heads
    hd = M // H
    ffn = int(M * 4 / 3)
    return {
        "conv": conv1d_init(gen, M, 4, dtype),
        "w_gates": dense_init(gen, M, 4 * M, bias=True, dtype=dtype),
        # block-diagonal recurrent weights: [H, hd, 4*hd]
        "r_gates": normal(gen, (H, hd, 4 * hd), 1.0 / math.sqrt(hd), dtype),
        "out_norm": rmsnorm_init(M, gen.device, dtype),
        "ffn_up": dense_init(gen, M, ffn * 2, dtype=dtype),
        "ffn_down": dense_init(gen, ffn, M, dtype=dtype),
    }


def slstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                device=None):
    M = cfg.d_model
    return {
        "c": torch.zeros((batch, M), dtype=dtype, device=device),
        "n": torch.zeros((batch, M), dtype=dtype, device=device),
        "m": torch.full((batch, M), -1e30, dtype=dtype, device=device),
        "h": torch.zeros((batch, M), dtype=dtype, device=device),
        "conv": torch.zeros((batch, 3, M), dtype=dtype, device=device),
    }


def _slstm_cell(params, cfg: ModelConfig, state, wx_t):
    """wx_t: [B, 4M] input contribution to the gates at time t."""
    B = wx_t.shape[0]
    M = cfg.d_model
    H = cfg.num_heads
    hd = M // H
    h_prev = state["h"].reshape(B, H, hd)
    rec = torch.einsum("bhd,hdg->bhg", h_prev,
                       params["r_gates"].to(h_prev.dtype)).reshape(B, 4 * M)
    g = (wx_t + rec).float()
    it, ft, zt, ot = g.chunk(4, dim=-1)
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + state["m"], it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + state["m"] - m_new)
    c_new = f_p * state["c"] + i_p * torch.tanh(zt)
    n_new = f_p * state["n"] + i_p
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1.0)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new,
            "conv": state["conv"]}, h_new


def slstm_apply(params, cfg: ModelConfig, x, state=None):
    B, S, M = x.shape
    if state is None:
        state = slstm_state(cfg, B, device=x.device)
    x_conv, conv_state = conv1d_apply(params["conv"], F.silu(x),
                                      state["conv"])
    wx = dense_apply(params["w_gates"], x_conv)              # [B,S,4M]
    hs = []
    for t in range(S):
        state, h_t = _slstm_cell(params, cfg, state, wx[:, t])
        hs.append(h_t)
    final = dict(state, conv=conv_state)
    h = torch.stack(hs, dim=1).to(x.dtype)                   # [B,S,M]
    h = rmsnorm_apply(params["out_norm"], h, cfg.norm_eps)
    # gated FFN (proj factor 4/3, as in the xLSTM paper's post-up-proj);
    # jax.nn.gelu defaults to the tanh approximation
    g, u = dense_apply(params["ffn_up"], h).chunk(2, dim=-1)
    y = dense_apply(params["ffn_down"], F.gelu(g, approximate="tanh") * u)
    return y, final


def slstm_step(params, cfg: ModelConfig, x, state):
    return slstm_apply(params, cfg, x, state)


# ---------------------------------------------------------------------------
# block pattern helper (xLSTM 7:1 mLSTM:sLSTM by default)
# ---------------------------------------------------------------------------

def xlstm_layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    pat = (cfg.recurrent.block_pattern if cfg.recurrent
           and cfg.recurrent.block_pattern else ("mlstm",) * 7 + ("slstm",))
    return tuple(pat[i % len(pat)] for i in range(cfg.num_layers))
