"""Public wrappers of ragged decode attention over a dense cache and over
page pools: dispatch by the tensors' device. A CPU tensor takes the plain
version; a CUDA tensor launches the hand-written kernels or raises. A
call launches two kernels (split-KV, then the combine) and counts once;
it reads no length on the host, so it never waits for the card."""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_cuda_operands, check_tma_operands,
                                 counted, is_meta, refuse_grad)
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)


def _check_group(H: int, Kv: int, D: int) -> None:
    if H % Kv or H // Kv > kernel.MAX_GROUP \
            or (H // Kv) * D > kernel.MAX_GROUP_WIDTH:
        raise ValueError(f"unsupported GQA group: H={H}, Kv={Kv}, D={D}")


def _check_rows(name: str, kv) -> None:
    """The kernels index the cache's [Kv, D] rows (dense [B, C], paged
    [P, bs]) in 32 bits."""
    if kv.shape[0] * kv.shape[1] > 2 ** 31 - 1:
        raise ValueError(f"{name}: {kv.shape[0] * kv.shape[1]} cache rows "
                         "do not fit the kernels' 32-bit row index")


def _scratch(q, Kv: int, C: int):
    """The split kernel's f32 partials for a cache of C positions."""
    B, H, D = q.shape
    return torch.empty(kernel.scratch_numel(B, H, Kv, C, D),
                       dtype=torch.float32, device=q.device)


def _attended(lengths, cap: int, B: int) -> int:
    """Positions the rows attend: each row's length clamped to [0, cap]
    (a host read of ``lengths``, made only under a step counter); on
    ``meta`` operands, whose lengths are unknown, every row at ``cap``."""
    if is_meta(lengths):
        return B * cap
    return int(lengths.clamp(0, cap).sum())


def _decode_work(q, Kv: int, tokens: int, extra_bytes: int):
    B, H, D = q.shape
    es = q.element_size()
    nbytes = (2 * B * H * D + 2 * tokens * Kv * D) * es + 4 * B + extra_bytes
    return 4.0 * tokens * H * D, float(nbytes)


def decode_attention_work(q, k_cache, v_cache, lengths):
    """(FLOPs, bytes) of ``decode_attention``: q and the output once, each
    attended position's K and V row once and the lengths; 4·H·D FLOPs a
    position (QK and PV). A row counts its own length, not C."""
    tokens = _attended(lengths, k_cache.shape[1], q.shape[0])
    return _decode_work(q, k_cache.shape[2], tokens, 0)


def decode_attention_paged_work(q, k_pages, v_pages, lengths, block_table):
    """(FLOPs, bytes) of ``decode_attention_paged``: as the dense call's,
    plus the table entries of the live pages."""
    bs, n_blocks = k_pages.shape[1], block_table.shape[1]
    cap = n_blocks * bs
    if is_meta(lengths):
        tokens, pages = q.shape[0] * cap, q.shape[0] * n_blocks
    else:
        lens = lengths.clamp(0, cap)
        tokens = int(lens.sum())
        pages = int(((lens + bs - 1) // bs).sum())
    return _decode_work(q, k_pages.shape[2], tokens, 4 * pages)


def decode_attention(q, k_cache, v_cache, lengths):
    """q: [B,H,D]; k/v_cache: [B,C,Kv,D]; lengths: int [B] -> [B,H,D].

    ``lengths[b]`` is the number of leading cache positions row b attends
    over (the KV ledger's context length, clamped to [0, C]); 0 yields a
    zero output row. Any C runs: the kernel masks the ragged last chunk.
    K and V are read with 16-byte copies: 16-byte aligned, D a multiple
    of 8 in bf16 and of 4 in f32.
    """
    refuse_grad("decode_attention", q, k_cache, v_cache)
    return counted("decode_attention", decode_attention_work,
                   (q, k_cache, v_cache, lengths),
                   lambda: _decode_attention(q, k_cache, v_cache, lengths))


def _decode_attention(q, k_cache, v_cache, lengths):
    if q.device.type == "cpu":
        # contiguous, as the kernels' output is
        return decode_attention_ref(q, k_cache, v_cache,
                                    lengths).contiguous()
    if is_meta(q):
        return torch.empty_like(q)
    B, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache differ in shape")
    _check_group(H, k_cache.shape[2], D)
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32 [B]")
    check_cuda_operands("decode_attention", q, k_cache, v_cache,
                        index=(lengths,))
    check_tma_operands("decode_attention", k_cache, v_cache)
    _check_rows("decode_attention", k_cache)
    out = torch.empty_like(q)
    scratch = _scratch(q, k_cache.shape[2], k_cache.shape[1])
    kernel.decode_attention_cuda(q, k_cache, v_cache, lengths, scratch, out)
    decode_attention.launches += 1
    return out


#: calls that launched the kernels (plain-version calls on CPU tensors do
#: not count)
decode_attention.launches = 0


def decode_attention_paged(q, k_pages, v_pages, lengths, block_table):
    """q: [B,H,D]; k/v_pages: [P,bs,Kv,D] physical page pools; lengths:
    int [B]; block_table: int [B,n_blocks] -> [B,H,D].

    Logical block l of row b is page ``block_table[b, l]``; entries < 0
    are unallocated and read the reserved scratch page 0 (they lie past
    the row's length). ``lengths[b]`` is clamped to [0, n_blocks * bs];
    0 yields a zero row. Any page size runs: the kernels' chunks do not
    depend on it, so at any bs the result is bitwise the dense kernel's
    over the gathered contents. Pages are read as the dense cache is.
    """
    refuse_grad("decode_attention_paged", q, k_pages, v_pages)
    return counted("decode_attention_paged", decode_attention_paged_work,
                   (q, k_pages, v_pages, lengths, block_table),
                   lambda: _decode_attention_paged(q, k_pages, v_pages,
                                                   lengths, block_table))


def _decode_attention_paged(q, k_pages, v_pages, lengths, block_table):
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, lengths,
                                          block_table).contiguous()
    if is_meta(q):
        return torch.empty_like(q)
    B, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape[3] != D:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in shape")
    _check_group(H, k_pages.shape[2], D)
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32 [B]")
    if (block_table.dim() != 2 or block_table.shape[0] != B
            or block_table.shape[1] < 1 or block_table.dtype != torch.int32):
        raise ValueError("block_table must be int32 [B, n_blocks >= 1]")
    check_cuda_operands("decode_attention_paged", q, k_pages, v_pages,
                        index=(lengths, block_table))
    check_tma_operands("decode_attention_paged", k_pages, v_pages)
    _check_rows("decode_attention_paged", k_pages)
    out = torch.empty_like(q)
    scratch = _scratch(q, k_pages.shape[2],
                       block_table.shape[1] * k_pages.shape[1])
    kernel.decode_attention_paged_cuda(q, k_pages, v_pages, lengths,
                                       block_table, scratch, out)
    decode_attention_paged.launches += 1
    return out


#: calls that launched the kernels (plain-version calls on CPU tensors do
#: not count)
decode_attention_paged.launches = 0
