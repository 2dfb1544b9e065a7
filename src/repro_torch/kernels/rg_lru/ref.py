"""Plain PyTorch version of the RG-LRU gated linear recurrence
(RecurrentGemma, arXiv:2402.19427), gates precomputed:

    h_t = a_t * h_{t-1} + b_t        elementwise over W

a, b: [B,S,W] (any float type, read as f32, or as f64 when given f64);
h0: [B,W]. Returns (h [B,S,W] f32, h_last [B,W] f32; f64 for f64
operands). A sequential loop over S with a
separate multiply and add, so that each step rounds twice, as the
kernel's ``__fadd_rn(__fmul_rn(a, h), b)`` does.
"""
from __future__ import annotations

import torch


def wide(x):
    """x in f32, or in its own type when that is wider (f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rg_lru_scan_ref(a, b, h0):
    a, b = wide(a), wide(b)
    h = wide(h0)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rg_lru_scan_backward_ref(a, h0, hs, dhs, dh_last):
    """The gradient of ``rg_lru_scan_ref`` by the same scan run in reverse
    time (f32, or f64 for f64 operands). a: [B,S,W] (read as f32); h0: [B,W]; hs: the forward's h
    [B,S,W]; dhs [B,S,W] and dh_last [B,W]: the gradients of its two
    outputs. With g_t the gradient of h_t (dh_last seeds g_{S-1}):

        g_t = dhs_t + a_{t+1} g_{t+1};  da_t = g_t h_{t-1};  db_t = g_t

    and dh0 = a_0 g_0 (h_{-1} = h0). Returns (da, db, dh0), f32. Each
    step is one add and one multiply, each rounded, in the order the
    kernel (``csrc/rg_lru_bwd.cu``) takes them."""
    a, hs, dhs = wide(a), wide(hs), wide(dhs)
    carry = wide(dh_last)
    das, dbs = [], []
    for t in range(a.shape[1] - 1, -1, -1):
        g = dhs[:, t] + carry
        das.append(g * (hs[:, t - 1] if t > 0 else wide(h0)))
        dbs.append(g)
        carry = a[:, t] * g
    return (torch.stack(das[::-1], dim=1), torch.stack(dbs[::-1], dim=1),
            carry)
