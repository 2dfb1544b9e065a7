"""Plain PyTorch version of the RG-LRU gated linear recurrence
(RecurrentGemma, arXiv:2402.19427), gates precomputed:

    h_t = a_t * h_{t-1} + b_t        elementwise over W

a, b: [B,S,W] (any float type, read as f32); h0: [B,W]. Returns
(h [B,S,W] f32, h_last [B,W] f32). A sequential loop over S with a
separate multiply and add, so that each step rounds twice, as the
kernel's ``__fadd_rn(__fmul_rn(a, h), b)`` does.
"""
from __future__ import annotations

import torch


def rg_lru_scan_ref(a, b, h0):
    a, b = a.float(), b.float()
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
