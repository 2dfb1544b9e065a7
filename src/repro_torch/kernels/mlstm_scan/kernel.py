"""Launches of the hand-written CUDA mLSTM scan
(``repro_torch/csrc/mlstm_scan.cu``), which replaces
``repro.kernels.mlstm_scan.kernel.mlstm_scan_pallas``, on its two routes:
the recurrent kernel (one step at a time, for decode) and the chunkwise
pair (a per-chunk record, then the scan over chunks, for prefill)."""
from __future__ import annotations

import math

from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/mlstm_scan.cu"
REPLACES = "src/repro/kernels/mlstm_scan/kernel.py:65"

#: widest head the kernels take (csrc: kMaxD)
MAX_D = 1024
#: steps per chunk and rows of C per scan block (csrc: kChunk, kRows)
CHUNK = 16
ROWS = 32
#: f32 values of one chunk's record (csrc: kRec)
REC = CHUNK * CHUNK + 4 * CHUNK


def record_numel(BH: int, S: int) -> int:
    """f32 scratch of the chunkwise route: one record per (b, h, chunk)."""
    return BH * (-(-S // CHUNK)) * REC


def mlstm_scan_cuda(q, k, v, i_gate, log_f, C0, n0, m0, h, C, n, m) -> None:
    """The recurrent kernel, on the current stream. q/k/v/h [B,H,S,D];
    i_gate/log_f [B,H,S]; C0/C [B,H,D,D] (C may be C0); n0/n [B,H,D];
    m0/m [B,H] — contiguous f32 CUDA tensors, checked by the caller."""
    B, H, S, D = q.shape
    build.call("repro_mlstm_scan", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               i_gate.data_ptr(), log_f.data_ptr(), C0.data_ptr(),
               n0.data_ptr(), m0.data_ptr(), h.data_ptr(), C.data_ptr(),
               n.data_ptr(), m.data_ptr(), B * H, S, D)


def mlstm_scan_chunkwise_cuda(q, k, v, i_gate, log_f, C0, n0, m0, rec, h,
                              C, n, m) -> None:
    """The chunkwise pair, on the current stream: operands as
    ``mlstm_scan_cuda``, plus ``rec``, ``record_numel(B * H, S)`` f32;
    16-byte aligned, D % 4 == 0, checked by the caller."""
    B, H, S, D = q.shape
    build.call("repro_mlstm_scan_chunkwise", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), i_gate.data_ptr(), log_f.data_ptr(),
               C0.data_ptr(), n0.data_ptr(), m0.data_ptr(), rec.data_ptr(),
               h.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
               B * H, S, D)


BACKWARD_SOURCE = "src/repro_torch/csrc/mlstm_scan_bwd.cu"
#: steps per chunk of the backward, and the columns of its gradient and
#: state tiles (csrc/mlstm_scan_bwd.cu: L, kTileN); a state tile has
#: BACKWARD_STATE_ROWS rows (kStateRows)
BACKWARD_CHUNK = 64
BACKWARD_TILE = 128
BACKWARD_STATE_ROWS = 64


def backward_record_size() -> int:
    """f32 values of one chunk's record (csrc ``Rec::kSize``): P, R and
    the E prefix sums [L x L], g and w_e [L], g_e and three zeros."""
    L = BACKWARD_CHUNK
    return 3 * L * L + 2 * L + 4


def backward_scratch(BH: int, S: int, D: int) -> dict:
    """Shapes of the backward's f32 scratch (``csrc/mlstm_scan_bwd.cu``):
    the gates and m per step, the per-step sums, n for every step (within
    its chunk), n and dn at the chunks' edges, one record per chunk, the
    state entering every chunk (C) and the gradient leaving it (G), the
    column tiles' shares of seven per-step sums, and the state tiles'
    shares of <G_c, C_c>."""
    n_ck = -(-S // BACKWARD_CHUNK)
    n_jt = -(-D // BACKWARD_TILE)
    n_st = -(-D // BACKWARD_STATE_ROWS) * n_jt
    return {"gates": (BH, 4, S), "stats": (BH, 7, S), "nbuf": (BH, S, D),
            "nvec": (3, BH, n_ck, D),
            "rec": (BH, n_ck, backward_record_size()),
            "cst": (BH, n_ck, D, D), "gst": (BH, n_ck, D, D),
            "parts": (7, BH, n_jt, S), "zpart": (BH, n_ck, n_st)}


def backward_scratch_bytes(BH: int, S: int, D: int) -> int:
    """Bytes of ``backward_scratch``."""
    return 4 * sum(math.prod(shape) for shape in
                   backward_scratch(BH, S, D).values())


def backward_flops(BH: int, S: int, D: int) -> int:
    """The products the chunkwise algebra needs (2 flops a multiply-add),
    over chunks of Lc = min(L, S - t0) steps: the state pass forward,
    C_{c+1} = g_e C_c + V^T diag(w_e) K, for every chunk but the last
    (2 Lc D^2); the reverse pass, G_{c-1} = g_e G_c + dNum^T diag(g) Q, for
    every chunk (2 Lc D^2); Z_c = <G_c, C_c> (2 D^2); dh C_c, V G_c and
    K G_c^T (6 Lc D^2); and the five lower-triangular [Lc x Lc] products,
    Q K^T and dh V^T into the record, R K, R^T Q and P^T dNum (each
    Lc (Lc + 1) D). The n path, the row dots and the gate terms, some
    tens of flops a step and column, are left out (under 1% at D =
    1024)."""
    total, last = 0, -(-S // BACKWARD_CHUNK) - 1
    for c in range(last + 1):
        Lc = min(BACKWARD_CHUNK, S - c * BACKWARD_CHUNK)
        total += (2 * Lc * D * D * (c < last) + 2 * Lc * D * D + 2 * D * D
                  + 6 * Lc * D * D + 5 * Lc * (Lc + 1) * D)
    return BH * total


# The grid and index arithmetic of csrc/mlstm_scan_bwd.cu, for
# analysis/kernelcheck (no launch).

def grad_grid(S: int, D: int) -> int:
    """gridDim.x of the gradient kernel (gridDim.y is BH): ceil(D / 128)
    column tiles times ceil(S / L) chunks (mlstm_scan_bwd.cu:1258)."""
    return -(-D // BACKWARD_TILE) * -(-S // BACKWARD_CHUNK)


def grad_block(x: int, y: int, D: int) -> tuple:
    """(bh, chunk c, column tile j) of the gradient kernel's block
    (blockIdx.x = x, blockIdx.y = y) (mlstm_scan_bwd.cu:931)."""
    n_jt = -(-D // BACKWARD_TILE)
    return y, x // n_jt, x % n_jt


def grad_span(c: int, j: int, S: int, D: int) -> tuple:
    """(steps, columns) of [S, D] that block (c, j) writes in dq, dk and
    dv: rows t0 + row for row < Lc = min(L, S - t0) and columns col0 + col
    < D (mlstm_scan_bwd.cu:932, 960-961)."""
    t0, col0 = c * BACKWARD_CHUNK, j * BACKWARD_TILE
    Lc = min(BACKWARD_CHUNK, S - t0)
    return (range(t0, t0 + max(Lc, 0)),
            range(col0, min(col0 + BACKWARD_TILE, D)))


def state_tile(x: int, D: int) -> tuple:
    """(first row, first column) of the state kernel's tile x of the [D, D]
    state (mlstm_scan_bwd.cu:766-767)."""
    tiles_c = -(-D // BACKWARD_TILE)
    return (x // tiles_c) * BACKWARD_STATE_ROWS, (x % tiles_c) * BACKWARD_TILE


def state_span(x: int, D: int) -> tuple:
    """(rows, columns) of the state that tile x writes, under the mask
    row < D and column < D (mlstm_scan_bwd.cu:788)."""
    r0, c0 = state_tile(x, D)
    return (range(r0, min(r0 + BACKWARD_STATE_ROWS, D)),
            range(c0, min(c0 + BACKWARD_TILE, D)))


def state_offset(bh: int, c: int, S: int, D: int) -> int:
    """The first f32 of chunk c's C and G states of head bh in ``cst`` and
    ``gst``: (bh n_chunks + c) D^2; the state spans D^2 values from there
    (mlstm_scan_bwd.cu:852, 868, 939)."""
    n_ck = -(-S // BACKWARD_CHUNK)
    return (bh * n_ck + c) * D * D


def mlstm_scan_backward_cuda(q, k, v, i_gate, log_f, C0, n0, m0, h, dh, dC,
                             dn, dm, scratch, dq, dk, dv, di, dlf, dC0, dn0,
                             dm0) -> None:
    """The backward on the current stream: operands as ``mlstm_scan_cuda``
    plus h (the forward's output), dh and the final state's gradients;
    ``scratch`` the tensors of ``backward_scratch(B * H, S, D)``;
    the eight gradients written in place. Contiguous f32 CUDA tensors,
    16-byte aligned, D % 4 == 0, checked by the caller."""
    B, H, S, D = q.shape
    ptrs = [t.data_ptr() for t in (q, k, v, i_gate, log_f, C0, n0, m0, h,
                                   dh, dC, dn, dm)]
    ptrs += [scratch[name].data_ptr() for name in (
        "gates", "stats", "nbuf", "nvec", "rec", "cst", "gst", "parts",
        "zpart")]
    ptrs += [t.data_ptr() for t in (dq, dk, dv, di, dlf, dC0, dn0, dm0)]
    build.call("repro_mlstm_scan_backward", *ptrs, B * H, S, D)
