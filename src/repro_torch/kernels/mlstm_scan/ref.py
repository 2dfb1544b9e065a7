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


def _walk_m(gf, gi, wa, dm):
    """The reverse walk of m's max recurrence ([..., S] f32 gate terms):
    (di, dlf, dm0), in the order of ``mlstm_scan_backward_ref``."""
    S = gf.shape[-1]
    di, dlf = torch.empty_like(gf), torch.empty_like(gf)
    carry = dm
    for t in range(S - 1, -1, -1):
        dmt = carry - gf[..., t] - gi[..., t]
        dlf[..., t] = gf[..., t] + dmt * wa[..., t]
        di[..., t] = gi[..., t] + dmt * (1.0 - wa[..., t])
        carry = gf[..., t] + dmt * wa[..., t]
    return di, dlf, carry



def mlstm_scan_backward_chunkwise_ref(q, k, v, i_gate, log_f, C0, n0, m0,
                                      dh, dC=None, dn=None, dm=None,
                                      chunk=64, drop_seed=False):
    """``mlstm_scan_backward_ref``'s gradient by the chunkwise algebra of
    ``csrc/mlstm_scan_bwd.cu``, in plain PyTorch (the tests hold it against
    the step-by-step form). Per (b, h) and chunk c of ``chunk`` steps
    c0..e, with the forward's A_t = F_t - m_t, B_s = F_s - i_s (F the
    chunk's prefix sum of lf), g_t = exp(A_t + m_{c0-1}), w_{t,s} =
    exp(A_t - B_s) (s <= t; every factor <= 1), P = W * (Q K^T), dNum_t =
    dh_t / d_t, R = W * (dNum V^T), C_c the state entering chunk c and G_c
    the gradient reaching the state that leaves it (the last chunk's: dC):

        C_{c+1} = g_e C_c + V^T diag(w_e) K
        G_{c-1} = g_e G_c + dNum^T diag(g) Q       (G_{-1} = dC0)
        dQ = diag(g) dNum C_c + R K
        dK = diag(w_e) V G_c + R^T Q
        dV = diag(w_e) K G_c^T + P^T dNum

    plus the n path's terms, formed step by step (the kernels run that path
    as a two-level scan over the chunks, the same sums in another order).
    The gate terms need no D^2 contraction per step: a_t = f'_t <dC_t~,
    C_{t-1}> is, within its chunk (u, s over the chunk's steps),

        a_t = sum_{u>=t} g_u X_u + g_e Z + sum_{s<t} w_{e,s} Y_s
              + sum_{u>=t, s<t} R[u,s] (q_u . k_s)

    with X_u = dNum_u^T C_c q_u and Y_s = v_s^T G_c k_s (row dots of the
    dQ and dV products before their diagonal scale) and Z = <G_c, C_c>,
    one D^2 dot a chunk: sums of terms with weights <= 1, so nothing
    cancels. (The recurrence a_t = a_{t+1} + dh_t . h_t - v_t . dv_t from
    a_S = <dC, C_S> is exact too, but subtracts the decayed seed from
    terms of its size: in f32 it left dm0 1e-4 off at S = 300, D = 64.)
    Then df'_t f'_t = a_t + the n term, di'_t i'_t = v_t . dv_t + the n
    term, and the walk of m. ``drop_seed`` forms the gate terms from a G
    pass seeded with zero in place of dC: the checks' control, wrong
    wherever dC is not zero. Returns (dq, dk, dv, di, dlf, dC0, dn0,
    dm0)."""
    B, H, S, D = q.shape
    L = chunk
    dC = torch.zeros_like(C0) if dC is None else dC
    dn = torch.zeros_like(n0) if dn is None else dn
    dm = torch.zeros_like(m0) if dm is None else dm
    h = mlstm_scan_ref(q, k, v, i_gate, log_f, C0, n0, m0)[0]

    # m, f', i' and the n path, step by step
    m, n = m0, n0
    ms, fps, ips, was, ns, nqs = [], [], [], [], [], []
    for t in range(S):
        a = log_f[:, :, t] + m
        m_new = torch.maximum(a, i_gate[:, :, t])
        fps.append(torch.exp(a - m_new))
        ips.append(torch.exp(i_gate[:, :, t] - m_new))
        was.append(torch.where(a > i_gate[:, :, t], 1.0,
                               torch.where(a < i_gate[:, :, t], 0.0, 0.5)))
        n = fps[-1][..., None] * n + ips[-1][..., None] * k[:, :, t]
        ns.append(n)
        nqs.append((n * q[:, :, t]).sum(-1))
        ms.append(m_new)
        m = m_new
    fp, ip, wa, mt = (torch.stack(x, -1) for x in (fps, ips, was, ms))
    nq = torch.stack(nqs, -1)
    den = nq.abs().clamp(min=1.0)
    inv_d = 1.0 / den
    hh = (dh * h).sum(-1)
    dnq = torch.where(nq.abs() >= 1.0, -hh / den * torch.sign(nq), 0.0)
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    sf_n, si_n = torch.empty_like(fp), torch.empty_like(ip)
    for t in range(S - 1, -1, -1):
        dnt = dn + dnq[..., t, None] * q[:, :, t]
        nprev = ns[t - 1] if t > 0 else n0
        dq[:, :, t] = dnq[..., t, None] * ns[t]
        dk[:, :, t] = ip[..., t, None] * dnt
        sf_n[..., t] = (dnt * nprev).sum(-1)
        si_n[..., t] = (dnt * k[:, :, t]).sum(-1)
        dn = fp[..., t, None] * dnt
    dn0 = dn

    # per chunk: g, w, P, R (the record)
    recs = []
    for c0 in range(0, S, L):
        e = min(c0 + L, S)
        sl = slice(c0, e)
        F = torch.cumsum(log_f[:, :, sl], -1)
        mprev = m0 if c0 == 0 else mt[..., c0 - 1]
        A = F - mt[..., sl]
        Bs = F - i_gate[:, :, sl]
        g = torch.exp(A + mprev[..., None])
        tri = torch.ones(e - c0, e - c0, dtype=torch.bool,
                         device=q.device).tril()
        W = torch.where(tri, torch.exp(A[..., :, None] - Bs[..., None, :]),
                        0.0)
        QK = torch.einsum("bhtd,bhsd->bhts", q[:, :, sl], k[:, :, sl])
        dnum = dh[:, :, sl] * inv_d[..., sl, None]
        R = W * torch.einsum("bhtd,bhsd->bhts", dnum, v[:, :, sl])
        recs.append((sl, g, W[..., -1, :], W * QK, R, R * QK, dnum))

    def g_pass(seed):
        Gs, G = [None] * len(recs), seed
        for c in range(len(recs) - 1, -1, -1):
            sl, g, we, P, R, E, dnum = recs[c]
            Gs[c] = G
            G = g[..., -1, None, None] * G + torch.einsum(
                "bhu,bhur,bhud->bhrd", g, dnum, q[:, :, sl])
        return Gs, G

    # the state passes: C entering each chunk, G leaving each chunk
    Cs, C = [], C0
    for sl, g, we, P, R, E, dnum in recs:
        Cs.append(C)
        C = g[..., -1, None, None] * C + torch.einsum(
            "bhs,bhsr,bhsd->bhrd", we, v[:, :, sl], k[:, :, sl])
    Gs, dC0 = g_pass(dC)
    Gg = g_pass(torch.zeros_like(dC))[0] if drop_seed else Gs

    # the gradients and the gate terms, every chunk on its own
    dv = torch.empty_like(v)
    a = torch.empty_like(fp, dtype=torch.float64)
    for (sl, g, we, P, R, E, dnum), Cc, Gc, Gz in zip(recs, Cs, Gs, Gg):
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        dq1 = torch.einsum("bhtr,bhrd->bhtd", dnum, Cc)
        dq[:, :, sl] += g[..., None] * dq1 + R @ kc
        dk[:, :, sl] += we[..., None] * torch.einsum(
            "bhtr,bhrd->bhtd", vc, Gc) + R.transpose(-1, -2) @ qc
        dv[:, :, sl] = we[..., None] * torch.einsum(
            "bhtd,bhrd->bhtr", kc, Gc) + P.transpose(-1, -2) @ dnum
        X = (dq1 * qc).sum(-1).double()
        Y = torch.einsum("bhsd,bhrd,bhsr->bhs", kc, Gz, vc).double()
        Z = (Gz.double() * Cc.double()).sum((-1, -2))
        Lc = X.shape[-1]
        t = torch.arange(Lc, device=q.device)
        after = t[None, :] >= t[:, None]          # [t, u]: u >= t
        before = t[None, :] < t[:, None]          # [t, s]: s < t
        gX = torch.where(after, g.double()[..., None, :] * X[..., None, :],
                         0.0).sum(-1)
        wY = torch.where(before, (we.double() * Y)[..., None, :], 0.0).sum(-1)
        Eb = torch.einsum("tu,ts,bhus->bht", after.double(), before.double(),
                          E.double())
        a[..., sl] = gX + wY + Eb + (g[..., -1].double() * Z)[..., None]
    gf = (a + (sf_n * fp).double()).float()
    gi = (v * dv).sum(-1) + si_n * ip
    di, dlf, dm0 = _walk_m(gf, gi, wa, dm)
    return dq, dk, dv, di, dlf, dC0, dn0, dm0
