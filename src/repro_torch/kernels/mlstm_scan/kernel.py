"""Launches of the hand-written CUDA mLSTM scan
(``repro_torch/csrc/mlstm_scan.cu``), which replaces
``repro.kernels.mlstm_scan.kernel.mlstm_scan_pallas``, on its two routes:
the recurrent kernel (one step at a time, for decode) and the chunkwise
pair (a per-chunk record, then the scan over chunks, for prefill)."""
from __future__ import annotations

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
#: steps between the backward's checkpoints of C, and the side of its tiles
#: of C (csrc/mlstm_scan_bwd.cu kT, kTile)
BACKWARD_CHUNK = 16
BACKWARD_TILE = 64


def backward_scratch(BH: int, S: int, D: int) -> dict:
    """Shapes of the backward's f32 scratch (``csrc/mlstm_scan_bwd.cu``):
    gates and per-step sums, n for every step, C entering every chunk of
    ``BACKWARD_CHUNK`` steps, and the tiles' partials of dq, dk, dv, df'
    and di'."""
    n_ck = -(-S // BACKWARD_CHUNK)
    tiles = -(-D // BACKWARD_TILE)
    return {"gates": (BH, 3, S), "stats": (BH, 4, S), "nbuf": (BH, S, D),
            "ckpt": (BH, n_ck, D, D), "dq_part": (tiles, BH, S, D),
            "dk_part": (tiles, BH, S, D), "dv_part": (tiles, BH, S, D),
            "sf_part": (BH, tiles * tiles, S),
            "si_part": (BH, tiles * tiles, S)}


def mlstm_scan_backward_cuda(q, k, v, i_gate, log_f, C0, n0, m0, h, dh, dC,
                             dn, dm, scratch, dq, dk, dv, di, dlf, dC0, dn0,
                             dm0) -> None:
    """The backward on the current stream: operands as ``mlstm_scan_cuda``
    plus h (the forward's output), dh and the final state's gradients;
    ``scratch`` the tensors of ``backward_scratch``; the eight gradients
    written in place. Contiguous f32 CUDA tensors, 16-byte aligned, D % 4
    == 0, checked by the caller."""
    B, H, S, D = q.shape
    ptrs = [t.data_ptr() for t in (q, k, v, i_gate, log_f, C0, n0, m0, h,
                                   dh, dC, dn, dm)]
    ptrs += [scratch[name].data_ptr() for name in (
        "gates", "stats", "nbuf", "ckpt", "dq_part", "dk_part", "dv_part",
        "sf_part", "si_part")]
    ptrs += [t.data_ptr() for t in (dq, dk, dv, di, dlf, dC0, dn0, dm0)]
    build.call("repro_mlstm_scan_backward", *ptrs, B * H, S, D)
