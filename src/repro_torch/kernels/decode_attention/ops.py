"""Public wrappers of ragged decode attention over a dense cache and over
page pools: dispatch by the tensors' device. A CPU tensor takes the plain
version; a CUDA tensor launches the hand-written kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import check_cuda_operands
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)


def _check_group(H: int, Kv: int, D: int) -> None:
    if H % Kv or H // Kv > kernel.MAX_GROUP \
            or (H // Kv) * D > kernel.MAX_GROUP_WIDTH:
        raise ValueError(f"unsupported GQA group: H={H}, Kv={Kv}, D={D}")


def decode_attention(q, k_cache, v_cache, lengths):
    """q: [B,H,D]; k/v_cache: [B,C,Kv,D]; lengths: int [B] -> [B,H,D].

    ``lengths[b]`` is the number of leading cache positions row b attends
    over (the KV ledger's context length, clamped to [0, C]); 0 yields a
    zero output row. Any C runs: the kernel masks the ragged last tile.
    """
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths)
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
    out = torch.empty_like(q)
    kernel.decode_attention_cuda(q, k_cache, v_cache, lengths, out)
    decode_attention.launches += 1
    return out


#: kernel launches (plain-version calls on CPU tensors do not count)
decode_attention.launches = 0


def decode_attention_paged(q, k_pages, v_pages, lengths, block_table):
    """q: [B,H,D]; k/v_pages: [P,bs,Kv,D] physical page pools; lengths:
    int [B]; block_table: int [B,n_blocks] -> [B,H,D].

    Logical block l of row b is page ``block_table[b, l]``; entries < 0
    are unallocated and read the reserved scratch page 0 (they lie past
    the row's length). ``lengths[b]`` is clamped to [0, n_blocks * bs];
    0 yields a zero row. Any page size runs: the kernel's tile does not
    depend on it, so at any bs the result is bitwise the dense kernel's
    over the gathered contents.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, lengths,
                                          block_table)
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
    out = torch.empty_like(q)
    kernel.decode_attention_paged_cuda(q, k_pages, v_pages, lengths,
                                       block_table, out)
    decode_attention_paged.launches += 1
    return out


#: kernel launches (plain-version calls on CPU tensors do not count)
decode_attention_paged.launches = 0
