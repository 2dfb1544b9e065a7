"""Launches of the hand-written CUDA decode-attention kernel
(``repro_torch/csrc/decode_attention.cu``) in its two modes: dense, which
replaces ``repro.kernels.decode_attention.kernel.decode_attention_pallas``,
and paged, which replaces ``paged_decode_attention_pallas``."""
from __future__ import annotations

from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention/kernel.py:203"
PAGED_REPLACES = "src/repro/kernels/decode_attention/kernel.py:139"

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


def decode_attention_paged_cuda(q, k_pages, v_pages, lengths, block_table,
                                out) -> None:
    """Launch on the current stream. q [B,H,D]; k/v pages [P,bs,Kv,D];
    lengths int32 [B]; block_table int32 [B,n_blocks]; out [B,H,D] — all
    contiguous CUDA tensors, checked by the caller."""
    B, H, D = q.shape
    bs, Kv = k_pages.shape[1], k_pages.shape[2]
    build.call("repro_decode_attention_paged", build.DTYPE_CODES[q.dtype],
               q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
               lengths.data_ptr(), block_table.data_ptr(), out.data_ptr(),
               B, H, Kv, bs, block_table.shape[1], D)
