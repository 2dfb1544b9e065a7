"""GQA attention (PyTorch counterpart of ``repro.models.attention``):
full-sequence causal attention for prefill and single-token decode over a
dense ragged KV cache.

KV caches are dicts ``{"k": [B,C,Kv,Dh], "v": [B,C,Kv,Dh], "index": i32}``
with a scalar index (one sequence) or a per-slot ``[B]`` index vector
(continuous batching). Unlike the JAX package, decode writes the new K/V
row into the cache tensors IN PLACE (one row per slot instead of a new
cache per step); the returned dict holds the same k/v tensors and the
advanced index.

Routing differs from the reference in one deliberate place: with
``impl="decode_kernel"`` the reference runs prefill through ``_sdpa``
(``repro/models/attention.py:211-218``), while the port runs it through
the flash kernel — the same function, held against ``_sdpa`` by the
tests. MLA, ring/sliding windows, sequence-sharded decode and the paged
layout are not ported yet and raise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_apply, dense_init

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

ATTN_IMPLS = ("xla", "flash", "decode_kernel")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.mla_kv_lora_rank:
        raise NotImplementedError(
            "MLA attention is not ported yet (ROADMAP Queue 1 item 10)")
    if cfg.attention != "full":
        raise NotImplementedError(
            f"attention={cfg.attention!r} (ring/sliding windows) is not "
            "ported yet (ROADMAP Queue 1 item 3)")


# ---------------------------------------------------------------------------
# parameter init / caches
# ---------------------------------------------------------------------------

def attention_init(gen, cfg: ModelConfig, dtype=torch.float32):
    _check_supported(cfg)
    hd = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype=dtype),
    }


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int,
                  dtype=torch.bfloat16, device=None):
    hd = cfg.head_dim
    shape = (batch, capacity, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _causal_mask(q_pos, k_pos):
    """q_pos: [S_q], k_pos: [S_k] (absolute). True == attend."""
    return q_pos[:, None] >= k_pos[None, :]


def _sdpa(q, k, v, mask):
    """q: [B,Sq,H,Dh], k/v: [B,Sk,Kv,Dh] (GQA broadcast), mask [Sq,Sk] or
    [B,Sq,Sk]. Logits in f32, probabilities cast to v's dtype."""
    B, Sq, H, Dh = q.shape
    Kv = k.shape[2]
    groups = H // Kv
    qh = q.reshape(B, Sq, Kv, groups, Dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), k.float())
    logits = logits / math.sqrt(Dh)
    mask = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, Dh)


# ---------------------------------------------------------------------------
# full-sequence (prefill) attention
# ---------------------------------------------------------------------------

def _project_qkv(params, cfg: ModelConfig, x, positions):
    """GQA projections with RoPE; returns q, k, v and the rows to cache."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = dense_apply(params["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = dense_apply(params["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = dense_apply(params["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, {"k": k, "v": v}


def attention_fullseq(params, cfg: ModelConfig, x, positions,
                      cache: Optional[dict] = None, impl: str = "xla"):
    """Prefill attention over the whole sequence. ``impl`` "flash" or
    "decode_kernel" runs the flash kernel, "xla" the plain masked SDPA.
    If ``cache`` is given it is filled with this segment's K/V; returns
    (out, cache_or_None)."""
    _check_supported(cfg)
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn impl {impl!r} not in {ATTN_IMPLS}")
    B, S, _ = x.shape
    q, k, v, to_cache = _project_qkv(params, cfg, x, positions)
    if impl in ("flash", "decode_kernel"):
        out = flash_ops.flash_attention(q, k, v, causal=True)
    else:
        mask = _causal_mask(positions[0], positions[0])
        out = _sdpa(q, k, v, mask)
    out = dense_apply(params["wo"], out.reshape(B, S, -1))
    new_cache = None
    if cache is not None:
        new_cache = _prefill_cache(cache, to_cache, S)
    return out, new_cache


def _prefill_cache(cache, to_cache, S: int):
    """Write the segment's K/V into positions [0, min(S, C)) of the cache
    (full attention: no ring roll) and set the index to S."""
    C = cache["k"].shape[1]
    keep = min(S, C)
    new = dict(cache)
    for name, val in to_cache.items():
        new[name][:, :keep].copy_(val[:, S - keep:S])
    new["index"] = torch.full_like(cache["index"], S)
    return new


# ---------------------------------------------------------------------------
# single-token decode
# ---------------------------------------------------------------------------

def attention_decode(params, cfg: ModelConfig, x, cache, impl: str = "xla",
                     lengths=None):
    """x: [B, 1, M]; cache index == number of tokens already cached.
    ``lengths`` ([B] int32, optional) is the KV ledger's per-slot context
    length — the positions THIS step attends over; without it the length
    is recovered from the cache index. ``impl="decode_kernel"`` runs the
    ragged decode kernel, any other impl the plain masked SDPA. Returns
    (out [B,1,M], cache with the row written in place)."""
    _check_supported(cfg)
    B = x.shape[0]
    index = cache["index"]
    positions = (index.expand(B)[:, None] if index.dim() == 0
                 else index[:, None]).to(torch.int32)
    q, _, _, to_cache = _project_qkv(params, cfg, x, positions)
    C = cache["k"].shape[1]

    # per-slot scatter of the new row at min(index, C-1), in place
    slot = torch.clamp(positions[:, 0].long(), max=C - 1)
    batch_ix = torch.arange(B, device=x.device)
    for name, val in to_cache.items():
        cache[name].index_put_((batch_ix, slot),
                               val[:, 0].to(cache[name].dtype))
    new_cache = dict(cache, index=index + 1)

    if lengths is not None:
        lens = torch.clamp(lengths.to(torch.int32), 0, C)
    else:
        lens = torch.clamp(positions[:, 0] + 1, max=C)

    k_all = new_cache["k"].to(x.dtype)
    v_all = new_cache["v"].to(x.dtype)
    if impl == "decode_kernel":
        out = dec_ops.decode_attention(q[:, 0].contiguous(), k_all, v_all,
                                       lens.contiguous())[:, None]
    else:
        mask = (torch.arange(C, device=x.device)[None, None, :]
                < lens[:, None, None])                          # [B, 1, C]
        out = _sdpa(q, k_all, v_all, mask)
    out = dense_apply(params["wo"], out.reshape(B, 1, -1))
    return out, new_cache
