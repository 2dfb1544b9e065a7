"""Launch of the hand-written CUDA causal GQA flash attention
(``repro_torch/csrc/flash_attention.cu``), which replaces
``repro.kernels.flash_attention.kernel.flash_attention_pallas``."""
from __future__ import annotations

from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:85"

#: head dims the kernel is instantiated for (csrc dispatch_d)
HEAD_DIMS = (32, 64, 128, 256)


def flash_attention_cuda(q, k, v, out, causal: bool, window) -> None:
    """Launch on the current stream. q [B,S,H,D]; k/v [B,S,Kv,D]; out
    [B,S,H,D] — contiguous CUDA tensors, checked by the caller."""
    B, S, H, D = q.shape
    Kv = k.shape[2]
    build.call("repro_flash_attention", build.DTYPE_CODES[q.dtype],
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               B, S, H, Kv, D, int(bool(causal)),
               int(window) if window is not None else 0)
