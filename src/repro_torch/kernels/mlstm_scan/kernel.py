"""Launch of the hand-written CUDA mLSTM scan
(``repro_torch/csrc/mlstm_scan.cu``), which replaces
``repro.kernels.mlstm_scan.kernel.mlstm_scan_pallas``."""
from __future__ import annotations

from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/mlstm_scan.cu"
REPLACES = "src/repro/kernels/mlstm_scan/kernel.py:65"

#: widest head the kernel holds in registers (csrc: kMaxD)
MAX_D = 1024


def mlstm_scan_cuda(q, k, v, i_gate, log_f, C0, n0, m0, h, C, n, m) -> None:
    """Launch on the current stream. q/k/v/h [B,H,S,D]; i_gate/log_f
    [B,H,S]; C0/C [B,H,D,D]; n0/n [B,H,D]; m0/m [B,H] — contiguous f32
    CUDA tensors, checked by the caller."""
    B, H, S, D = q.shape
    build.call("repro_mlstm_scan", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               i_gate.data_ptr(), log_f.data_ptr(), C0.data_ptr(),
               n0.data_ptr(), m0.data_ptr(), h.data_ptr(), C.data_ptr(),
               n.data_ptr(), m.data_ptr(), B * H, S, D)
