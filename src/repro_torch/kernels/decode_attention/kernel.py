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


# ---------------------------------------------------------------------------
# The kernels' index arithmetic, stated in Python: the CUDA source computes
# its indices itself, so ``analysis.kernelcheck`` evaluates these mirrors
# over boundary cases. Each names the lines of csrc/decode_attention.cu it
# states; a change there changes them.
# ---------------------------------------------------------------------------

def split_block(x: int, n_chunks: int, B: int, Kv: int) -> tuple:
    """(chunk j, row b, KV head) of split block ``x`` of the grid's
    ``B * Kv * n_chunks``: the chunk-major decode of ``blockIdx.x``
    (decode_attention.cu:174-178)."""
    grid = B * Kv * n_chunks                    # gridDim.x
    n_bk = grid // n_chunks
    j = x // n_bk
    bk = x - j * n_bk
    b = bk // Kv
    return j, b, bk - b * Kv


def chunk_live(j: int, length: int, C: int) -> int:
    """Live positions of chunk ``j`` of a row of ``length`` (clamped to
    [0, C]); 0: the block returns at once (decode_attention.cu:179-182)."""
    p0 = j * CHUNK
    ln = max(0, min(length, C))
    return 0 if p0 >= ln else min(CHUNK, ln - p0)


def partial_slot(b: int, kvh: int, j: int, Kv: int, n_chunks: int,
                 g: int) -> int:
    """The first (m, l) pair the split block (b, kvh, j) writes in the
    scratch: ``((b * Kv + kvh) * n_chunks + j) * g``
    (decode_attention.cu:336-338); it writes g of them."""
    return ((b * Kv + kvh) * n_chunks + j) * g


def dense_rows(b: int, p0: int, n: int, C: int) -> list:
    """``DenseRows::prepare``: the [Kv, D] row of each of the chunk's n
    positions from p0 in the [B * C] rows of the cache
    (decode_attention.cu:113-119)."""
    return [b * C + p0 + p for p in range(n)]


def paged_rows(table_row, p0: int, n: int, bs: int) -> list:
    """``PagedRows::prepare``: the row of each position in the pool's
    [P * bs] rows, through the row's table entries, each clamped to 0 (an
    unallocated entry, -1, reads the scratch page)
    (decode_attention.cu:121-138)."""
    first = p0 // bs
    n_ent = (p0 + n - 1) // bs - first + 1
    ent = [max(int(table_row[first + t]), 0) for t in range(n_ent)]
    return [ent[(p0 + p) // bs - first] * bs + (p0 + p) % bs
            for p in range(n)]
