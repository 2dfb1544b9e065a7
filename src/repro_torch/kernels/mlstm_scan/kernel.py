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
