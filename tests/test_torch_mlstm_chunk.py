"""The chunkwise mLSTM scan's arithmetic on the CPU.

The CUDA route for prefill (``repro_torch/csrc/mlstm_scan.cu``) cuts S
into chunks of ``CHUNK`` steps. A prep kernel walks the m recurrence in
the plain version's order and writes, per (b, h, chunk), the decays
g_t = exp(F_t + m_{c0-1} - m_t), the weights w_{e,s} of the chunk's last
step and the masked scores P[t,s] = w_{t,s} (q_t . k_s); the scan kernel
then carries (C, n) over the chunks with two matrix products per chunk.
Both run only on the card, where chip_smoke.py holds them to the plain
version. Here a small f32 torch model of that arithmetic is held against
the JAX package's Pallas kernel (interpret mode) and the port's plain
version, at the chunk's edges, from a fresh and from a non-zero state,
and at chip_smoke's full width with one head; m must be bitwise equal.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.kernels.mlstm_scan.kernel import mlstm_scan_pallas  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as mk  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops  # noqa: E402
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref  # noqa: E402

L = mk.CHUNK
TOL = dict(rtol=1e-5, atol=1e-5)
SOURCE = Path(__file__).resolve().parents[1] / mk.SOURCE


def chunk_records(lf, ig, m0, S, L=L):
    """The prep kernel: per chunk (g [B,H,L], w_e [B,H,L], A, Bs) with
    A_t = F_t - m_t and B_s = F_s - i_s, and the m track [B,H,S] walked
    step by step as the plain version walks it."""
    m = m0
    ms = []
    for t in range(S):
        m = torch.maximum(lf[..., t] + m, ig[..., t])
        ms.append(m)
    recs = []
    for c0 in range(0, S, L):
        Lc = min(L, S - c0)
        mprev = m0 if c0 == 0 else ms[c0 - 1]
        F = torch.zeros_like(m0)
        A, Bs = [], []
        for t in range(Lc):
            F = F + lf[..., c0 + t]
            A.append(F - ms[c0 + t])
            Bs.append(F - ig[..., c0 + t])
        A, Bs = torch.stack(A, -1), torch.stack(Bs, -1)
        g = torch.exp(A + mprev[..., None])
        w_e = torch.exp(A[..., -1:] - Bs)
        recs.append((c0, Lc, g, w_e, A, Bs))
    return recs, torch.stack(ms, -1)


def chunkwise_scan(q, k, v, ig, lf, C0, n0, m0, L=L):
    """The scan kernel over ``chunk_records``: per chunk
    H = diag(g) Q C^T + P V, n.q = g (Q n) + rowsum P, then
    C <- g_e C + (V w_e)^T K, n <- g_e n + w_e K."""
    S = q.shape[2]
    recs, ms = chunk_records(lf, ig, m0, S, L)
    C, n = C0, n0
    hs = []
    for c0, Lc, g, w_e, A, Bs in recs:
        Q, K, V = (x[:, :, c0:c0 + Lc] for x in (q, k, v))
        mask = torch.tril(torch.ones(Lc, Lc, dtype=torch.bool))
        w = torch.exp(A[..., :, None] - Bs[..., None, :]) * mask
        P = w * (Q @ K.transpose(-1, -2))
        Hc = g[..., None] * (Q @ C.transpose(-1, -2)) + P @ V
        dot = g * (Q @ n[..., None])[..., 0] + P.sum(-1)
        hs.append(Hc / torch.clamp(dot.abs(), min=1.0)[..., None])
        ge = g[..., -1]
        WV = (V * w_e[..., None]).transpose(-1, -2)
        C = ge[..., None, None] * C + WV @ K
        n = ge[..., None] * n + (w_e[..., None] * K).sum(-2)
    return torch.cat(hs, 2), C, n, ms[..., -1]


def _inputs(B, H, S, D, seed=0, fresh=False):
    rng = np.random.RandomState(seed)
    f = np.float32
    q = rng.randn(B, H, S, D).astype(f)
    k = (rng.randn(B, H, S, D) / np.sqrt(D)).astype(f)
    v = rng.randn(B, H, S, D).astype(f)
    ig = rng.randn(B, H, S).astype(f)
    lf = np.log(1 / (1 + np.exp(-(rng.randn(B, H, S) + 3)))).astype(f)
    if fresh:       # as models/ssm.mlstm_state makes it
        C0 = np.zeros((B, H, D, D), f)
        n0 = np.zeros((B, H, D), f)
        m0 = np.full((B, H), -1e30, f)
    else:
        C0 = (0.1 * rng.randn(B, H, D, D)).astype(f)
        n0 = (0.1 * rng.randn(B, H, D)).astype(f)
        m0 = rng.randn(B, H).astype(f)
    return q, k, v, ig, lf, C0, n0, m0


def _check(got, want, tol):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)
    assert np.array_equal(np.asarray(got[3]), np.asarray(want[3]))


@pytest.mark.parametrize("fresh", [False, True])
def test_chunkwise_matches_pallas(fresh):
    """Two full chunks (the Pallas kernel's block divides S)."""
    args = _inputs(2, 2, 2 * L, 16, seed=1, fresh=fresh)
    got = chunkwise_scan(*(torch.from_numpy(a) for a in args))
    want = mlstm_scan_pallas(*(jnp.asarray(a) for a in args), bs=L,
                             interpret=True)
    _check(got, want, TOL)


@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("S", [1, L - 1, L, L + 1, 2 * L + 3])
def test_chunkwise_matches_plain_at_chunk_edges(S, fresh):
    args = [torch.from_numpy(a) for a in _inputs(1, 2, S, 32, seed=S,
                                                 fresh=fresh)]
    _check(chunkwise_scan(*args), mlstm_scan_ref(*args), TOL)


def test_chunkwise_matches_plain_at_full_width():
    """chip_smoke's shape with one head: D = 1024, S = 600 (37 full
    chunks and a ragged one), held to chip_smoke's MLSTM_TOL."""
    args = [torch.from_numpy(a) for a in _inputs(1, 1, 600, 1024, seed=3)]
    _check(chunkwise_scan(*args), mlstm_scan_ref(*args),
           chip_smoke.MLSTM_TOL)


def test_decays_stay_at_most_one():
    """g and every w_{t,s} (s <= t) are <= 1 by the max recurrence, from a
    fresh and a non-zero state: nothing overflows in the records."""
    for fresh in (False, True):
        _, _, _, ig, lf, _, _, m0 = (torch.from_numpy(a) for a in _inputs(
            2, 2, 3 * L + 5, 8, seed=4, fresh=fresh))
        recs, _ = chunk_records(lf, ig, m0, lf.shape[-1])
        for _, Lc, g, w_e, A, Bs in recs:
            w = torch.exp(A[..., :, None] - Bs[..., None, :])
            mask = torch.tril(torch.ones(Lc, Lc, dtype=torch.bool))
            assert (g <= 1 + 1e-6).all() and (w_e <= 1 + 1e-6).all()
            assert (w[..., mask] <= 1 + 1e-6).all()


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def test_python_constants_match_the_source():
    """The model's chunk and the wrapper's record size follow the CUDA
    source's kChunk and kRows."""
    assert _constant("kChunk") == mk.CHUNK
    assert _constant("kRows") == mk.ROWS
    assert mk.REC == mk.CHUNK * mk.CHUNK + 4 * mk.CHUNK
    assert mk.record_numel(8, 2 * L + 1) == 8 * 3 * mk.REC


def test_route_by_s_alone(monkeypatch):
    """The wrapper takes the recurrent kernel below CHUNKWISE_MIN_S (a
    decode step, S = 1) and the chunkwise pair from it on, reading only
    the shape; each call counts one launch. The device checks and the
    launches are faked: nothing runs a kernel here (the meta operands
    stand in for CUDA ones, so the wrapper's meta branch is turned off)."""
    assert ops.route(1) == "recurrent"
    assert ops.route(ops.CHUNKWISE_MIN_S - 1) == "recurrent"
    assert ops.route(ops.CHUNKWISE_MIN_S) == "chunkwise"
    assert ops.route(600) == "chunkwise"
    taken = []
    monkeypatch.setattr(ops, "check_cuda_operands", lambda *a, **kw: None)
    monkeypatch.setattr(ops, "check_tma_operands", lambda *a, **kw: None)
    monkeypatch.setattr(ops, "is_meta", lambda t: False)
    monkeypatch.setattr(mk, "mlstm_scan_cuda",
                        lambda *a: taken.append("recurrent"))
    monkeypatch.setattr(mk, "mlstm_scan_chunkwise_cuda",
                        lambda *a: taken.append("chunkwise"))
    tk.reset_launch_counts()
    for S in (1, ops.CHUNKWISE_MIN_S, 37):
        args = [torch.empty(a.shape, device="meta")
                for a in _inputs(2, 2, S, 8)]
        h, C, n, m = ops.mlstm_scan(*args)
        assert h.shape == (2, 2, S, 8) and C.shape == (2, 2, 8, 8)
    assert taken == ["recurrent", "chunkwise", "chunkwise"]
    assert tk.launch_counts()["mlstm_scan"] == 3
    tk.reset_launch_counts()
