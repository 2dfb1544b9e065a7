"""Launches of the hand-written CUDA decode-attention kernels
(``repro_torch/csrc/decode_attention.cu``) in their two modes: dense, which
replaces ``repro.kernels.decode_attention.kernel.decode_attention_pallas``,
and paged, which replaces ``paged_decode_attention_pallas``. Each call
launches two kernels: split-KV over chunks of ``CHUNK`` positions, which
writes f32 partials into ``scratch``, and the combine pass."""
from __future__ import annotations

from repro_torch.kernels import build

SOURCE = "src/repro_torch/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention/kernel.py:203"
PAGED_REPLACES = "src/repro/kernels/decode_attention/kernel.py:139"

#: limits and sizes of the kernels (csrc: kMaxGroup, kMaxGroupWidth, kChunk)
MAX_GROUP = 128          # query heads per KV head
MAX_GROUP_WIDTH = 4096   # query heads per KV head times head_dim
CHUNK = 64               # cache positions per split


def scratch_numel(B: int, H: int, Kv: int, C: int, D: int) -> int:
    """f32 values of the partials for a cache of ``C`` positions, laid out
    as the CUDA source's ``launch`` reads them: the (m, l) pairs
    [B, Kv, n_chunks, g], then acc [B, Kv, n_chunks, g, D], with
    n_chunks = ceil(C / CHUNK) and g = H / Kv. It follows from the shapes
    alone, never from the lengths."""
    return B * H * (-(-C // CHUNK)) * (D + 2)


def decode_attention_cuda(q, k_cache, v_cache, lengths, scratch,
                          out) -> None:
    """Launch on the current stream. q [B,H,D]; k/v [B,C,Kv,D]; lengths
    int32 [B]; scratch f32 of ``scratch_numel``; out [B,H,D] — all
    contiguous CUDA tensors, checked by the caller."""
    B, H, D = q.shape
    C, Kv = k_cache.shape[1], k_cache.shape[2]
    build.call("repro_decode_attention", build.DTYPE_CODES[q.dtype],
               q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
               lengths.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, H,
               Kv, C, D)


def decode_attention_paged_cuda(q, k_pages, v_pages, lengths, block_table,
                                scratch, out) -> None:
    """Launch on the current stream. q [B,H,D]; k/v pages [P,bs,Kv,D];
    lengths int32 [B]; block_table int32 [B,n_blocks]; scratch f32 of
    ``scratch_numel`` with C = n_blocks * bs; out [B,H,D] — all contiguous
    CUDA tensors, checked by the caller."""
    B, H, D = q.shape
    bs, Kv = k_pages.shape[1], k_pages.shape[2]
    build.call("repro_decode_attention_paged", build.DTYPE_CODES[q.dtype],
               q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
               lengths.data_ptr(), block_table.data_ptr(),
               scratch.data_ptr(), out.data_ptr(), B, H, Kv, bs,
               block_table.shape[1], D)
