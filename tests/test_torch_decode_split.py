"""The decode-attention kernels' split-KV arithmetic on the CPU.

The CUDA kernels (``repro_torch/csrc/decode_attention.cu``) cut each row
into chunks of ``CHUNK`` positions, take each live chunk's exact softmax
partials (max m, sum l, unnormalised acc) and combine the chunks in order
with a log-sum-exp rescale. They run only on the card, where chip_smoke.py
holds them to the plain versions. Here a small model of that arithmetic
in f32 torch is held against the JAX package's Pallas kernels (interpret
mode) and the port's plain versions, at the chunk's edges, at GQA groups
of 1, 4 and 6 and at page sizes below, at and above the chunk.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_pallas, paged_decode_attention_pallas)
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_attention_paged)
from repro_torch.kernels.decode_attention.ref import gather_pages  # noqa: E402

P = dec_kernel.CHUNK
TOL = dict(rtol=1e-5, atol=1e-5)
SOURCE = Path(__file__).resolve().parents[1] / dec_kernel.SOURCE


def split_partials(q, k, v, lengths, chunk=P):
    """The split kernel's partials: {(b, kv head): [(m [g], l [g],
    acc [g, D]) per live chunk, in chunk order]}. q [B,H,D], k/v
    [B,C,Kv,D], f32."""
    B, H, D = q.shape
    C, Kv = k.shape[1], k.shape[2]
    g = H // Kv
    parts = {}
    for b in range(B):
        n = max(0, min(int(lengths[b]), C))
        for kvh in range(Kv):
            qs = q[b, kvh * g:(kvh + 1) * g] * (1.0 / math.sqrt(D))
            row = []
            for p0 in range(0, n, chunk):
                kc = k[b, p0:min(p0 + chunk, n), kvh]
                vc = v[b, p0:min(p0 + chunk, n), kvh]
                s = qs @ kc.T                                   # [g, n_j]
                m = s.max(-1).values
                e = torch.exp(s - m[:, None])
                row.append((m, e.sum(-1), e @ vc))
            parts[b, kvh] = row
    return parts


def split_attention(q, k, v, lengths, chunk=P):
    """The combine kernel over ``split_partials``: the chunks rescaled to
    their common max and summed in chunk order; exact zeros for a row
    with no live chunk."""
    B, H, D = q.shape
    Kv = k.shape[2]
    g = H // Kv
    out = torch.zeros(B, H, D)
    for (b, kvh), row in split_partials(q, k, v, lengths, chunk).items():
        if not row:
            continue
        mx = torch.stack([m for m, _, _ in row]).max(0).values
        l = torch.zeros(g)
        acc = torch.zeros(g, D)
        for m, lj, aj in row:
            w = torch.exp(m - mx)
            l = l + lj * w
            acc = acc + aj * w[:, None]
        out[b, kvh * g:(kvh + 1) * g] = acc / l[:, None]
    return out


def _dense_case(lengths, C, Kv, g, D=32, seed=0):
    rng = np.random.RandomState(seed)
    B = len(lengths)
    q = rng.randn(B, Kv * g, D).astype(np.float32)
    k = rng.randn(B, C, Kv, D).astype(np.float32)
    v = rng.randn(B, C, Kv, D).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# the chunk's edges, and C = 2P + 37 (no chunk multiple)
EDGES = [0, 1, P - 1, P, P + 1, 2 * P + 37]


@pytest.mark.parametrize("g", [1, 4, 6])
def test_split_matches_pallas_and_plain(g):
    C = 2 * P + 37
    q, k, v, lens = _dense_case(EDGES, C, 2, g, seed=g)
    split = split_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    pallas = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lens),
                                     interpret=True)
    plain = decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    _close(split, pallas)
    _close(split, plain)
    assert not split[0].any()                   # length 0: exact zeros
    # live chunks per row: ceil(len / P), C never enters
    parts = split_partials(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    assert [len(parts[b, 0]) for b in range(len(EDGES))] == \
        [-(-n // P) for n in EDGES]


def test_split_one_live_position_in_the_last_chunk():
    """Rows of P + 1 and 2P + 1: the last chunk holds one live position
    and the rest of it is masked. That position's score is far below the
    other chunks' max, so its weight in the combine underflows towards
    zero; every chunk's max stays finite (a dead chunk writes nothing and
    is never combined)."""
    lengths = [P + 1, 2 * P + 1, 1]
    C = 3 * P
    q, k, v, lens = _dense_case(lengths, C, 1, 4, seed=7)
    k[:, P] *= -40.0            # the lone position of row 0's last chunk
    k[:, 2 * P] *= 40.0         # ... and a dominant one in row 1
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    parts = split_partials(tq, tk, tv, tl)
    assert [len(parts[b, 0]) for b in range(3)] == [2, 3, 1]
    for row in parts.values():
        for m, l, _ in row:
            assert torch.isfinite(m).all() and (l >= 1).all()
    split = split_attention(tq, tk, tv, tl)
    _close(split, decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        interpret=True))
    _close(split, decode_attention(tq, tk, tv, tl))


def _paged(lengths, bs, Kv, g, D=32, seed=0):
    """Dense contents and the same contents in shuffled pages (page 0 the
    scratch page, -1 past a row's pages)."""
    n_blocks = max(-(-n // bs) for n in lengths)
    q, k, v, lens = _dense_case(lengths, n_blocks * bs, Kv, g, D, seed)
    pool = 1 + sum(-(-n // bs) for n in lengths)
    order = np.random.RandomState(seed).permutation(
        np.arange(1, pool)).tolist()
    kp = np.zeros((pool, bs, Kv, D), np.float32)
    vp = np.zeros((pool, bs, Kv, D), np.float32)
    tbl = np.full((len(lengths), n_blocks), -1, np.int32)
    for b, n in enumerate(lengths):
        for c in range(-(-n // bs)):
            page = order.pop()
            tbl[b, c] = page
            kp[page] = k[b, c * bs:(c + 1) * bs]
            vp[page] = v[b, c * bs:(c + 1) * bs]
    return q, k, v, kp, vp, lens, tbl


@pytest.mark.parametrize("bs", [16, 48, P, 80])
def test_split_paged_matches_pallas_at_any_page_size(bs):
    """Page sizes below the chunk (dividing it and not), equal, above:
    the split over the gathered pages is the split over the dense
    contents, bit for bit (chunks follow logical positions, not pages),
    and matches the paged Pallas kernel and the port's plain version."""
    q, k, v, kp, vp, lens, tbl = _paged([0, 1, P - 1, P, P + 1, 200], bs,
                                        2, 3, seed=bs)
    tq, tkp, tvp, tl, tt = (torch.from_numpy(a)
                            for a in (q, kp, vp, lens, tbl))
    kd, vd = gather_pages(tkp, tt), gather_pages(tvp, tt)
    split = split_attention(tq, kd, vd, tl)
    assert torch.equal(split, split_attention(
        tq, torch.from_numpy(k), torch.from_numpy(v), tl))
    _close(split, paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(tbl), interpret=True))
    _close(split, decode_attention_paged(tq, tkp, tvp, tl, tt))
    assert not split[0].any()


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def test_python_constants_match_the_source():
    """The wrapper sizes the scratch and refuses groups from kernel.py's
    constants; they must be the CUDA source's."""
    assert _constant("kChunk") == dec_kernel.CHUNK
    assert _constant("kMaxGroup") == dec_kernel.MAX_GROUP
    assert _constant("kMaxGroupWidth") == dec_kernel.MAX_GROUP_WIDTH

