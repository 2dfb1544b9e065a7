"""Launch of the hand-written CUDA grouped SwiGLU expert GEMM
(``repro_torch/csrc/moe_gemm.cu``), which replaces
``repro.kernels.moe_gemm.kernel.moe_gemm_pallas``."""
from __future__ import annotations

from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/moe_gemm.cu"
REPLACES = "src/repro/kernels/moe_gemm/kernel.py:45"


def moe_gemm_cuda(x, w_gate, w_up, w_down, act, out) -> None:
    """Two launches on the current stream: ``act = silu(x Wg) * (x Wu)``
    (stored in x's dtype), then ``out = act Wd``; bf16 runs the TMA +
    wgmma kernel, f32 the SIMT kernel. x [E,C,M]; Wg/Wu [E,M,H]; Wd
    [E,H,M]; act [E,C,H]; out [E,C,M] — contiguous CUDA tensors, checked
    by the caller."""
    E, C, M = x.shape
    H = w_gate.shape[-1]
    build.call("repro_moe_gemm", build.DTYPE_CODES[x.dtype], x.data_ptr(),
               w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
               act.data_ptr(), out.data_ptr(), E, C, M, H)
