"""Launch of the hand-written CUDA RG-LRU scan
(``repro_torch/csrc/rg_lru.cu``), which replaces
``repro.kernels.rg_lru.kernel.rg_lru_scan_pallas``."""
from __future__ import annotations

from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/rg_lru.cu"
REPLACES = "src/repro/kernels/rg_lru/kernel.py:46"


def rg_lru_scan_cuda(a, b, h0, h, h_last) -> None:
    """Launch on the current stream. a/b [B,S,W] (f32 or bf16, one type);
    h0/h_last [B,W] f32; h [B,S,W] f32 — contiguous CUDA tensors, checked
    by the caller."""
    B, S, W = a.shape
    build.call("repro_rg_lru_scan", build.DTYPE_CODES[a.dtype],
               a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
               h_last.data_ptr(), B, S, W)


BACKWARD_SOURCE = "src/repro_torch/csrc/rg_lru_bwd.cu"


def rg_lru_scan_backward_cuda(a, hs, h0, dhs, dh_last, da, db, dh0) -> None:
    """The backward on the current stream. a/hs/dhs/da/db [B,S,W];
    h0/dh_last/dh0 [B,W] — contiguous f32 CUDA tensors, checked by the
    caller."""
    B, S, W = a.shape
    build.call("repro_rg_lru_scan_backward", a.data_ptr(), hs.data_ptr(),
               h0.data_ptr(), dhs.data_ptr(), dh_last.data_ptr(),
               da.data_ptr(), db.data_ptr(), dh0.data_ptr(), B, S, W)
