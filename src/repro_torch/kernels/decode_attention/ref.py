"""Plain PyTorch version of ragged single-token GQA decode attention: row b
attends the first ``lengths[b]`` cache positions."""
from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q: [B,H,D]; k/v_cache: [B,C,Kv,D]; lengths: int [B] -> [B,H,D].

    Length-0 rows (freshly-freed slots) return exact zeros — a dense
    softmax over an all-masked row would return the mean of V instead.
    """
    B, H, D = q.shape
    C, Kv = k_cache.shape[1], k_cache.shape[2]
    g = H // Kv
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    qh = q.reshape(B, Kv, g, D).float()
    valid = (torch.arange(C, device=q.device)[None, :]
             < lengths[:, None])                               # [B, C]
    logits = torch.einsum("bkgd,bskd->bkgs", qh,
                          k_cache.float()) / math.sqrt(D)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = torch.where((lengths > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, H, D).to(q.dtype)


def gather_pages(pages, block_table):
    """[P,bs,Kv,D] pages + int [B,n] table -> dense [B, n*bs, Kv, D].
    Unallocated entries (< 0) clamp to page 0; their positions sit past
    the row's length, so the masked attention never reads them."""
    B, n = block_table.shape
    bs, Kv, D = pages.shape[1], pages.shape[2], pages.shape[3]
    tbl = torch.clamp(block_table.to(device=pages.device, dtype=torch.long),
                      min=0)
    return pages[tbl].reshape(B, n * bs, Kv, D)


def paged_decode_attention_ref(q, k_pages, v_pages, lengths, block_table):
    """Plain version of the paged kernel: gather each row's page chain
    into a dense cache, then run the dense plain version."""
    return decode_attention_ref(q, gather_pages(k_pages, block_table),
                                gather_pages(v_pages, block_table), lengths)
