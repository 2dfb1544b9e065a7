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
