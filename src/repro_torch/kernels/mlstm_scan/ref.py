"""Plain PyTorch version of the stabilised mLSTM matrix-memory recurrence
(xLSTM, arXiv:2405.04517):

    m_t = max(lf_t + m_{t-1}, i_t)
    f'  = exp(lf_t + m_{t-1} - m_t);  i' = exp(i_t - m_t)
    C_t = f' C_{t-1} + i' v_t k_t^T
    n_t = f' n_{t-1} + i' k_t
    h_t = C_t q_t / max(|n_t . q_t|, 1)

q,k,v: [B,H,S,D] (k pre-scaled by 1/sqrt(D)); i,lf: [B,H,S] (lf = log
sigmoid of the raw forget gate). Returns (h [B,H,S,D], C, n, m finals).
"""
from __future__ import annotations

import torch


def mlstm_scan_ref(q, k, v, i_gate, log_f, C0, n0, m0):
    C, n, m = C0, n0, m0
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        it, lft = i_gate[:, :, t], log_f[:, :, t]
        m_new = torch.maximum(lft + m, it)
        f_p = torch.exp(lft + m - m_new)[..., None]
        i_p = torch.exp(it - m_new)[..., None]
        n = f_p * n + i_p * kt
        C = f_p[..., None] * C + (i_p * vt)[..., None] * kt[..., None, :]
        denom = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n, qt)),
                            min=1.0)
        hs.append(torch.einsum("bhvd,bhd->bhv", C, qt) / denom[..., None])
        m = m_new
    return torch.stack(hs, dim=2), C, n, m
