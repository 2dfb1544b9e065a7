"""Launch of the hand-written CUDA decode-attention kernel
(``repro_torch/csrc/decode_attention.cu``), which replaces
``repro.kernels.decode_attention.kernel.decode_attention_pallas``."""
from __future__ import annotations

from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention/kernel.py:203"

#: limits of the kernel (csrc: kThreads and kThreads * kMaxAcc)
MAX_GROUP = 128          # query heads per KV head
MAX_GROUP_WIDTH = 4096   # query heads per KV head times head_dim


def decode_attention_cuda(q, k_cache, v_cache, lengths, out) -> None:
    """Launch on the current stream. q [B,H,D]; k/v [B,C,Kv,D]; lengths
    int32 [B]; out [B,H,D] — all contiguous CUDA tensors, checked by the
    caller."""
    B, H, D = q.shape
    C, Kv = k_cache.shape[1], k_cache.shape[2]
    build.call("repro_decode_attention", build.DTYPE_CODES[q.dtype],
               q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               lengths.data_ptr(), out.data_ptr(), B, H, Kv, C, D)
