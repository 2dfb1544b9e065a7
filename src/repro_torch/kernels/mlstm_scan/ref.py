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


def mlstm_scan_backward_ref(q, k, v, i_gate, log_f, C0, n0, m0, dh,
                            dC=None, dn=None, dm=None, drop_dm=False):
    """The gradient of ``mlstm_scan_ref`` with respect to q, k, v,
    i_gate, log_f, C0, n0 and m0, given dh [B,H,S,D] and the gradients of
    the final C, n and m (None: zero). The forward is recomputed and every
    state kept (D^2 values a head a step), then the steps run in reverse.
    With num_t = C_t q_t and d_t = max(|n_t . q_t|, 1):

        dC_t~ = dC_t + (dh_t / d_t) q_t^T
        dn_t~ = dn_t + dnq_t q_t,  dnq_t = -(dh_t . h_t) / d_t
                                            * sign(n_t . q_t) [|n_t . q_t| >= 1]
        dq_t  = C_t^T dh_t / d_t + dnq_t n_t
        dv_t  = i'_t dC_t~ k_t;  dk_t = i'_t (dC_t~^T v_t + dn_t~)
        df'_t = <dC_t~, C_{t-1}> + dn_t~ . n_{t-1}
        di'_t = v_t^T dC_t~ k_t + dn_t~ . k_t
        dC_{t-1} = f'_t dC_t~,  dn_{t-1} = f'_t dn_t~

    The stabiliser m carries a gradient: where the clamp holds d_t at 1,
    h_t scales with exp(-m_t). f' = exp(lf_t + m_{t-1} - m_t) and
    i' = exp(i_t - m_t) give dlf_t and di_t their direct terms
    (df' f', di' i'), and dm_t = dm_{t+1 carried} - df' f' - di' i' flows
    through m_t = max(lf_t + m_{t-1}, i_t) to lf_t and m_{t-1} or to i_t
    (half each on a tie, as ``torch.maximum``'s gradient). ``drop_dm``
    leaves that flow out (m held constant): the checks' control, wrong
    exactly where the clamp is active. Returns (dq, dk, dv, di, dlf, dC0,
    dn0, dm0)."""
    S = q.shape[2]
    C, n, m = C0, n0, m0
    Cs, ns, ms, fps, ips, nqs, dens, hs = [C0], [n0], [m0], [], [], [], [], []
    for t in range(S):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        it, lft = i_gate[:, :, t], log_f[:, :, t]
        m_new = torch.maximum(lft + m, it)
        f_p = torch.exp(lft + m - m_new)
        i_p = torch.exp(it - m_new)
        n = f_p[..., None] * n + i_p[..., None] * kt
        C = f_p[..., None, None] * C + (i_p[..., None] * vt)[..., None] \
            * kt[..., None, :]
        nq = torch.einsum("bhd,bhd->bh", n, qt)
        den = torch.clamp(torch.abs(nq), min=1.0)
        hs.append(torch.einsum("bhvd,bhd->bhv", C, qt) / den[..., None])
        m = m_new
        Cs.append(C)
        ns.append(n)
        ms.append(m)
        fps.append(f_p)
        ips.append(i_p)
        nqs.append(nq)
        dens.append(den)
    dC = torch.zeros_like(C0) if dC is None else dC
    dn = torch.zeros_like(n0) if dn is None else dn
    dm_c = torch.zeros_like(m0) if dm is None else dm
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, dlf = torch.empty_like(i_gate), torch.empty_like(log_f)
    for t in range(S - 1, -1, -1):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        dht, den, nq = dh[:, :, t], dens[t], nqs[t]
        f_p, i_p = fps[t], ips[t]
        dnum = dht / den[..., None]
        dnq = (-(dht * hs[t]).sum(-1) / den * torch.sign(nq)
               * (nq.abs() >= 1.0))
        dCt = dC + dnum[..., :, None] * qt[..., None, :]
        dnt = dn + dnq[..., None] * qt
        dq[:, :, t] = torch.einsum("bhvd,bhv->bhd", Cs[t + 1], dnum) \
            + dnq[..., None] * ns[t + 1]
        dCk = torch.einsum("bhvd,bhd->bhv", dCt, kt)
        dv[:, :, t] = i_p[..., None] * dCk
        dk[:, :, t] = i_p[..., None] * (
            torch.einsum("bhvd,bhv->bhd", dCt, vt) + dnt)
        dfp = (dCt * Cs[t]).sum((-1, -2)) + (dnt * ns[t]).sum(-1)
        dip = (vt * dCk).sum(-1) + (dnt * kt).sum(-1)
        gf, gi = dfp * f_p, dip * i_p
        if drop_dm:
            dlf[:, :, t], di[:, :, t] = gf, gi
            dm_c = gf
        else:
            a = log_f[:, :, t] + ms[t]
            it = i_gate[:, :, t]
            wa = torch.where(a > it, 1.0, torch.where(a < it, 0.0, 0.5))
            dmt = dm_c - gf - gi
            dlf[:, :, t] = gf + dmt * wa
            di[:, :, t] = gi + dmt * (1.0 - wa)
            dm_c = gf + dmt * wa
        dC = f_p[..., None, None] * dCt
        dn = f_p[..., None] * dnt
    return dq, dk, dv, di, dlf, dC, dn, dm_c
