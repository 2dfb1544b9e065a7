"""Attention (PyTorch counterpart of ``repro.models.attention``): GQA and
MLA (DeepSeek-V2 latent attention), full-sequence causal attention for
prefill and single-token decode over a dense ragged KV cache, or (GQA
only) over page pools through a block table.

KV caches are dicts with a scalar index (one sequence) or a per-slot
``[B]`` index vector (continuous batching):

  GQA: ``{"k": [B,C,Kv,Dh], "v": [B,C,Kv,Dh], "index": i32}``
  MLA: ``{"ckv": [B,C,r], "kpe": [B,C,Dh], "index": i32}`` — the latent
       ``x @ w_dkv`` and the RoPE'd shared key part ``x @ w_kpe``; decode
       recomputes K/V of every cached position through ``w_ukv`` (MHA,
       Kv == H), as the reference does.

Unlike the JAX package, decode writes the new row into the cache tensors
IN PLACE (one row per slot instead of a new cache per step); the
returned dict holds the same tensors and the advanced index.

Local and sliding attention (``cfg.attention`` "local"/"sliding") keep a
ring cache capped at the window (``cache_capacity``): the token at
absolute position p lives in slot p % C. Prefill masks by the window and
rolls the kept segment into that layout; ring decode writes slot
``index % C`` and masks from absolute positions, ignoring the ledger's
lengths (which pass C), and always runs the plain masked SDPA, as the
reference does.

Routing differs from the reference in one deliberate place: with
``impl="decode_kernel"`` (and, for MLA, ``impl="flash"``) the reference
runs prefill through ``_sdpa`` (``repro/models/attention.py:211-218``),
while the port runs it through the flash kernel (with the window, if
any; on MLA's Kv == H tensors) — the same function, held against
``_sdpa`` by the tests. MLA decode runs the plain masked ``_sdpa`` under
every impl, as the reference does.

On a mesh (``tp``, a ``models.parallel.TensorParallel``: the sharded
prefill and decode steps) each rank attends its own heads where the
heads divide the model axis, with its projections' columns, and sums its
share of ``wo`` over the axis; otherwise it gathers the q/k/v
activations and attends every head. Where the KV heads do not divide
the axis and the capacity does, the cache is split along the sequence
and decode with a scalar index runs ``decode_core_seqsharded``, the
reference's ``_decode_core_seqsharded`` (a distributed softmax: each
rank's slots, ``all_reduce`` MAX and SUM in place of ``pmax``/``psum``),
under the reference's own condition (``use_seqsharded_decode``).

The encoder-decoder family adds two blocks. The encoder's bidirectional
self-attention (``encoder_self_attention``, the reference's
``repro/models/transformer.py:584-595``) runs the flash kernel with
``causal=False`` under "flash" and "decode_kernel", where the reference
runs ``_sdpa``. Cross-attention (``cross_attention_apply``) takes q from
the decoder and k/v from the encoder's memory, with no RoPE and every
memory position attended; one decode query a row runs the dense decode
kernel under "decode_kernel" with every length at the memory's, where
the reference runs ``_sdpa``, and every other call the plain ``_sdpa``
(Sq != Sk: the flash kernel takes equal lengths only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import parallel as tp_lib
from repro_torch.models.layers import apply_rope, dense_apply, dense_init

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

ATTN_IMPLS = ("xla", "flash", "decode_kernel")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attention not in ("full", "sliding", "local", "mla"):
        raise NotImplementedError(
            f"attention={cfg.attention!r} has no attention layer")


def is_ring(cfg: ModelConfig) -> bool:
    """Local and sliding attention keep a ring cache of the window."""
    return cfg.attention in ("sliding", "local")


# ---------------------------------------------------------------------------
# parameter init / caches
# ---------------------------------------------------------------------------

def attention_init(gen, cfg: ModelConfig, dtype=torch.float32):
    """The reference's parameters: wq, wk, wv, wo (GQA), or wq, w_dkv,
    w_ukv, w_kpe, wo (MLA); only wq (and GQA's wk, wv) take the config's
    qkv bias."""
    _check_supported(cfg)
    hd = cfg.head_dim
    if cfg.mla_kv_lora_rank:
        r = cfg.mla_kv_lora_rank
        return {
            "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd,
                             bias=cfg.qkv_bias, dtype=dtype),
            "w_dkv": dense_init(gen, cfg.d_model, r, dtype=dtype),
            "w_ukv": dense_init(gen, r, cfg.num_heads * 2 * hd, dtype=dtype),
            "w_kpe": dense_init(gen, cfg.d_model, hd, dtype=dtype),
            "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model,
                             dtype=dtype),
        }
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype=dtype),
    }


def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Ring caches (sliding/local attention) cap capacity at the window."""
    if is_ring(cfg):
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int,
                  dtype=torch.bfloat16, device=None):
    hd = cfg.head_dim
    index = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.mla_kv_lora_rank:
        return {"ckv": torch.zeros((batch, capacity, cfg.mla_kv_lora_rank),
                                   dtype=dtype, device=device),
                "kpe": torch.zeros((batch, capacity, hd), dtype=dtype,
                                   device=device),
                "index": index}
    shape = (batch, capacity, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": index}


def cache_len(cache) -> int:
    """Positions a dense or ring cache holds (C), from whichever tensor
    it has: ``ckv`` (MLA) or ``k``."""
    return (cache["ckv"] if "ckv" in cache else cache["k"]).shape[1]


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _causal_mask(q_pos, k_pos, window: Optional[int] = None):
    """q_pos: [S_q], k_pos: [S_k] (absolute). True == attend."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


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
    """Projections with RoPE; returns q, k, v and the rows to cache. MLA
    gives MHA tensors (Kv == H): k = k_nope + rope(kpe), with kpe shared
    by every head, and caches the latent ``ckv`` and the RoPE'd ``kpe``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = dense_apply(params["wq"], x).reshape(B, S, cfg.num_heads, hd)
    if cfg.mla_kv_lora_rank:
        ckv = dense_apply(params["w_dkv"], x)                    # [B,S,r]
        kv = dense_apply(params["w_ukv"], ckv)
        kv = kv.reshape(B, S, cfg.num_heads, 2 * hd)
        k_nope, v = torch.split(kv, hd, dim=-1)
        kpe = dense_apply(params["w_kpe"], x)[:, :, None, :]     # [B,S,1,hd]
        kpe = apply_rope(kpe, positions, cfg.rope_theta)
        k = k_nope + kpe
        q = apply_rope(q, positions, cfg.rope_theta)
        return q, k, v, {"ckv": ckv, "kpe": kpe[:, :, 0, :]}
    k = dense_apply(params["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = dense_apply(params["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, {"k": k, "v": v}


def attention_fullseq(params, cfg: ModelConfig, x, positions,
                      cache: Optional[dict] = None, impl: str = "xla",
                      tp=None):
    """Prefill attention over the whole sequence, masked by the window
    under local/sliding attention. ``impl`` "flash" or "decode_kernel"
    runs the flash kernel, "xla" the plain masked SDPA. If ``cache`` is
    given it is filled with this segment's K/V; returns
    (out, cache_or_None). ``tp`` runs the rank's share on a mesh (the
    module docstring)."""
    _check_supported(cfg)
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn impl {impl!r} not in {ATTN_IMPLS}")
    if tp is not None:
        return _attention_fullseq_tp(params, cfg, x, positions, cache, impl,
                                     tp)
    B, S, _ = x.shape
    q, k, v, to_cache = _project_qkv(params, cfg, x, positions)
    out = _fullseq_core(cfg, q, k, v, positions, impl)
    out = dense_apply(params["wo"], out.reshape(B, S, -1))
    new_cache = None
    if cache is not None:
        new_cache = _prefill_cache(cache, to_cache, S)
    return out, new_cache


def _fullseq_core(cfg: ModelConfig, q, k, v, positions, impl: str):
    """Causal (windowed under local/sliding attention) attention of q
    [B,S,H,Dh] over k/v [B,S,Kv,Dh] -> [B,S,H,Dh]."""
    window = cfg.sliding_window if is_ring(cfg) else None
    if impl in ("flash", "decode_kernel"):
        # the kernel reads dense rows: MLA's v is a strided view of the
        # up-projection, a rank's heads a slice
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return flash_ops.flash_attention(q, k, v, causal=True, window=window)
    mask = _causal_mask(positions[0], positions[0], window)
    return _sdpa(q, k, v, mask)


def _prefill_cache(cache, to_cache, S: int):
    """Write the segment's last min(S, C) K/V rows into slots [0, keep) of
    the cache, in place, and set the index to S. When the segment fills
    the cache and S % C != 0 the rows are rolled by S % C, which keeps the
    ring invariant: slot s holds the absolute position that is s mod C.
    Every tensor of the cache (k and v, or MLA's ckv and kpe) is written."""
    C = cache_len(cache)
    keep = min(S, C)
    new = dict(cache)
    for name, val in to_cache.items():
        seg = val[:, S - keep:S]
        if keep == C and S % C:
            seg = torch.roll(seg, S % C, dims=1)
        new[name][:, :keep].copy_(seg)
    new["index"] = torch.full_like(cache["index"], S)
    return new


def _prefill_cache_seqsplit(cache, to_cache, S: int, tp):
    """``_prefill_cache`` on a cache split along the sequence: this rank
    holds slots [r·Cl, (r+1)·Cl) of the C = Cl·mo, and writes the part of
    the segment's kept (rolled) rows that lands there."""
    Cl = cache["k"].shape[1]
    C = Cl * tp.size
    keep = min(S, C)
    lo = tp.rank * Cl
    hi = min(lo + Cl, keep)
    new = dict(cache)
    for name, val in to_cache.items():
        seg = val[:, S - keep:S]
        if keep == C and S % C:
            seg = torch.roll(seg, S % C, dims=1)
        if hi > lo:
            new[name][:, :hi - lo].copy_(seg[:, lo:hi])
    new["index"] = torch.full_like(cache["index"], S)
    return new


# ---------------------------------------------------------------------------
# single-token decode
# ---------------------------------------------------------------------------

class PagedAddress(NamedTuple):
    """One decode step's paged-KV addresses (see ``paged_address``)."""
    table: torch.Tensor       # int32 [B, max_blocks], < 0 = unallocated
    positions: torch.Tensor   # int32 [B, 1]: the new token's position
    phys: torch.Tensor        # long [B]: page of the new K/V row
    row: torch.Tensor         # long [B]: its row within that page
    lens: torch.Tensor        # int32 [B]: positions attended


def paged_address(block_table, index, bs: int, lengths=None) -> PagedAddress:
    """Work out one decode step's page addresses once for every attention
    layer: the layers hold the same per-slot ``index`` (tokens cached), and
    one ``block_table`` (int32 [B, max_blocks]) addresses every layer's
    page pool. The new row goes to page ``max(tbl[b, pos // bs], 0)`` at
    row ``pos % bs``, with ``pos`` clamped to the table's capacity; dead
    rows (no pages) land on the reserved scratch page 0, so they never
    touch live KV. ``lengths`` (the KV ledger's, else ``index + 1``) are
    clamped to [0, max_blocks * bs]."""
    tbl = block_table.to(dtype=torch.int32).contiguous()
    B = tbl.shape[0]
    if index.dim() == 0:
        index = index.expand(B)
    C = tbl.shape[1] * bs
    pos = torch.clamp(index.long(), max=C - 1)
    batch_ix = torch.arange(B, device=tbl.device)
    phys = torch.clamp(tbl[batch_ix, pos // bs].long(), min=0)
    if lengths is not None:
        lens = torch.clamp(lengths.to(torch.int32), 0, C)
    else:
        lens = torch.clamp(index.to(torch.int32) + 1, max=C)
    return PagedAddress(tbl, index[:, None].to(torch.int32), phys, pos % bs,
                        lens.contiguous())


def _cached_kv(params, cfg: ModelConfig, cache, dtype):
    """K/V of every cached position in ``dtype``: the cache's k/v, or for
    MLA the whole latent cache through ``w_ukv`` plus the shared ``kpe``
    (the reference's decode recompute, ``repro/models/attention.py:406-
    411``). It reads the fixed-shape cache, never a length, so a captured
    decode step replays it."""
    if not cfg.mla_kv_lora_rank:
        return cache["k"].to(dtype), cache["v"].to(dtype)
    ckv = cache["ckv"]
    B, C, _ = ckv.shape
    hd = cfg.head_dim
    kv = dense_apply(params["w_ukv"], ckv.to(dtype))
    k_nope, v = torch.split(kv.reshape(B, C, cfg.num_heads, 2 * hd), hd,
                            dim=-1)
    return k_nope + cache["kpe"].to(dtype)[:, :, None, :], v


def attention_decode(params, cfg: ModelConfig, x, cache, impl: str = "xla",
                     lengths=None, paged: Optional[PagedAddress] = None,
                     tp=None):
    """x: [B, 1, M]; cache index == number of tokens already cached.
    ``lengths`` ([B] int32, optional) is the KV ledger's per-slot context
    length — the positions THIS step attends over; without it the length
    is recovered from the cache index. A ring cache (local/sliding
    attention) ignores ``lengths``: it writes slot ``index % C`` and masks
    from absolute positions. ``paged`` (the step's ``paged_address``)
    switches the cache to the paged layout
    (``repro_torch.runtime.paging``). ``impl="decode_kernel"`` runs the
    ragged decode kernel on a full-attention GQA cache; a ring cache, an
    MLA cache (K/V recomputed from the latent, ``_cached_kv``) and any
    other impl run the plain masked SDPA. ``tp`` runs the rank's share on
    a mesh (the module docstring). Returns (out [B,1,M], cache with the
    row written in place)."""
    if paged is not None:
        if tp is not None:
            raise NotImplementedError("paged KV decode on a mesh")
        return _attention_decode_paged(params, cfg, x, cache, impl, paged)
    _check_supported(cfg)
    B = x.shape[0]
    index = cache["index"]
    positions = (index.expand(B)[:, None] if index.dim() == 0
                 else index[:, None]).to(torch.int32)
    if tp is not None:
        return _attention_decode_tp(params, cfg, x, cache, impl, lengths,
                                    positions, tp)
    q, _, _, to_cache = _project_qkv(params, cfg, x, positions)
    out, new_cache = _decode_core(params, cfg, q, cache, to_cache,
                                  positions, impl, lengths)
    out = dense_apply(params["wo"], out.reshape(B, 1, -1))
    return out, new_cache


def _decode_core(params, cfg: ModelConfig, q, cache, to_cache, positions,
                 impl: str, lengths):
    """Write the new rows ``to_cache`` into ``cache`` in place and attend
    q [B,1,H,Dh] over it -> (out [B,1,H,Dh], cache with the index
    advanced)."""
    B = q.shape[0]
    index = cache["index"]
    C = cache_len(cache)
    ring = is_ring(cfg)
    dev = q.device

    # per-slot scatter of the new row, in place: at index % C in a ring,
    # else at min(index, C-1)
    pos = positions[:, 0].long()
    slot = pos % C if ring else torch.clamp(pos, max=C - 1)
    batch_ix = torch.arange(B, device=dev)
    for name, val in to_cache.items():
        cache[name].index_put_((batch_ix, slot),
                               val[:, 0].to(cache[name].dtype))
    new_cache = dict(cache, index=index + 1)
    k_all, v_all = _cached_kv(params, cfg, new_cache, q.dtype)

    if ring:
        # slot s holds the latest absolute position p <= index with
        # p = s (mod C); it is attended when 0 <= p and index - p < C
        idx = pos[:, None]                                      # [B, 1]
        slots = torch.arange(C, device=dev)[None, :]
        base = torch.div(idx - slots, C, rounding_mode="floor") * C + slots
        k_pos = torch.where(base > idx, base - C, base)
        mask = ((k_pos >= 0) & (k_pos <= idx)
                & (idx - k_pos < C))[:, None, :]                # [B, 1, C]
        return _sdpa(q, k_all, v_all, mask), new_cache

    if lengths is not None:
        lens = torch.clamp(lengths.to(torch.int32), 0, C)
    else:
        lens = torch.clamp(positions[:, 0] + 1, max=C)

    if impl == "decode_kernel" and not cfg.mla_kv_lora_rank:
        out = dec_ops.decode_attention(q[:, 0].contiguous(),
                                       k_all.contiguous(), v_all.contiguous(),
                                       lens.contiguous())[:, None]
    else:
        mask = (torch.arange(C, device=dev)[None, None, :]
                < lens[:, None, None])                          # [B, 1, C]
        out = _sdpa(q, k_all, v_all, mask)
    return out, new_cache


def _attention_decode_paged(params, cfg: ModelConfig, x, cache, impl,
                            paged: PagedAddress):
    """Paged-KV decode: the cache's k/v are physical page pools
    ``[P, bs, Kv, D]`` shared by every slot, addressed through the step's
    ``paged`` (table, new-row page and row, lengths). The new row is
    written IN PLACE into its tail page. ``impl="decode_kernel"`` runs the
    paged kernel; other impls gather the page chains and run the plain
    masked SDPA. MLA and ring/sliding windows have no paged layout and
    raise."""
    if cfg.mla_kv_lora_rank or is_ring(cfg):
        raise NotImplementedError(
            "paged KV decode requires full-attention GQA "
            f"(attention={cfg.attention!r}, mla={cfg.mla_kv_lora_rank})")
    B = x.shape[0]
    q, _, _, to_cache = _project_qkv(params, cfg, x, paged.positions)
    # Several dead rows may write the same scratch-page position: with
    # duplicate indices index_put_ keeps one of the writes, which one is
    # not defined. That is harmless, since no live row maps page 0.
    for name, val in to_cache.items():
        cache[name].index_put_((paged.phys, paged.row),
                               val[:, 0].to(cache[name].dtype))
    new_cache = dict(cache, index=cache["index"] + 1)

    if impl == "decode_kernel":
        out = dec_ops.decode_attention_paged(
            q[:, 0].contiguous(), new_cache["k"], new_cache["v"],
            paged.lens, paged.table)[:, None]
    else:
        k_all = dec_ref.gather_pages(new_cache["k"], paged.table).to(x.dtype)
        v_all = dec_ref.gather_pages(new_cache["v"], paged.table).to(x.dtype)
        C = k_all.shape[1]
        mask = (torch.arange(C, device=x.device)[None, None, :]
                < paged.lens[:, None, None])                    # [B, 1, C]
        out = _sdpa(q, k_all, v_all, mask)
    out = dense_apply(params["wo"], out.reshape(B, 1, -1))
    return out, new_cache


# ---------------------------------------------------------------------------
# a rank's share on a mesh (tensor parallel over the model axis)
# ---------------------------------------------------------------------------

def use_seqsharded_decode(cfg: ModelConfig, mo: int, capacity: int) -> bool:
    """The reference's rule (``repro/models/attention.py:248-260``):
    sequence-shard the decode cache over a model axis of ``mo`` when the
    KV-head count does not divide it and the capacity does (never MLA)."""
    if cfg.mla_kv_lora_rank:
        return False
    return cfg.num_kv_heads % mo != 0 and capacity % mo == 0


def _tp_heads(cfg: ModelConfig, tp, every: bool = False):
    """((q_lo, q_hi), (kv_lo, kv_hi)): the heads this rank attends. When
    the heads divide the axis each rank takes its block of q heads and
    the KV heads they read (a whole number of groups, or part of one
    group); else, or with ``every``, all of them."""
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    if not every and H % tp.size == 0:
        Hl, g = H // tp.size, H // Kv
        if Hl % g == 0 or g % Hl == 0:
            qa, qb = tp.rank * Hl, (tp.rank + 1) * Hl
            return (qa, qb), (qa // g, (qb - 1) // g + 1)
    return (0, H), (0, Kv)


def _tp_cfg(cfg: ModelConfig, heads, kv) -> ModelConfig:
    return dataclasses.replace(cfg, num_heads=heads[1] - heads[0],
                               num_kv_heads=kv[1] - kv[0],
                               head_dim=cfg.head_dim)


def _tp_project(params, cfg: ModelConfig, x, positions, tp, heads, kv,
                cache_kv):
    """The rank's q (heads ``heads``), k and v (KV heads ``kv``) with
    RoPE, and the rows to cache (KV heads ``cache_kv``; MLA: the whole
    latent)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    H, Kv = cfg.num_heads, cfg.num_kv_heads

    def take(p, inp, n, width, rng):
        y = tp_lib.take_columns(p, inp, n * width, rng[0] * width,
                                rng[1] * width, tp)
        return y.reshape(B, S, rng[1] - rng[0], width)

    q = apply_rope(take(params["wq"], x, H, hd, heads), positions,
                   cfg.rope_theta)
    if cfg.mla_kv_lora_rank:
        ckv = dense_apply(params["w_dkv"], x)
        kv_ = take(params["w_ukv"], ckv, H, 2 * hd, heads)
        k_nope, v = torch.split(kv_, hd, dim=-1)
        kpe = apply_rope(dense_apply(params["w_kpe"], x)[:, :, None, :],
                         positions, cfg.rope_theta)
        return q, k_nope + kpe, v, {"ckv": ckv, "kpe": kpe[:, :, 0, :]}
    k_c = apply_rope(take(params["wk"], x, Kv, hd, cache_kv), positions,
                     cfg.rope_theta)
    v_c = take(params["wv"], x, Kv, hd, cache_kv)
    a, b = kv[0] - cache_kv[0], kv[1] - cache_kv[0]
    return q, k_c[:, :, a:b], v_c[:, :, a:b], {"k": k_c, "v": v_c}


def _tp_out(params, cfg: ModelConfig, out, tp):
    """``wo`` of the rank's heads' output [B,S,h,Dh] (row-parallel: the
    rank's rows, summed over the axis)."""
    B, S = out.shape[:2]
    return tp_lib.row_parallel(params["wo"], out.reshape(B, S, -1),
                               cfg.num_heads * cfg.head_dim, tp)


def _cache_kv_heads(cfg: ModelConfig, tp, kv):
    """The KV heads a rank's cache holds: its block when the KV heads
    divide the axis (the cache is split by heads), else all of them."""
    if cfg.num_kv_heads % tp.size == 0:
        return kv
    return (0, cfg.num_kv_heads)


def _attention_fullseq_tp(params, cfg: ModelConfig, x, positions, cache,
                          impl: str, tp):
    if cfg.mla_kv_lora_rank and cfg.num_heads % tp.size:
        raise NotImplementedError("MLA on a mesh whose model axis does not "
                                  "divide the heads")
    S = x.shape[1]
    heads, kv = _tp_heads(cfg, tp)
    if cfg.mla_kv_lora_rank:
        kv = heads
    q, k, v, to_cache = _tp_project(params, cfg, x, positions, tp, heads, kv,
                                    _cache_kv_heads(cfg, tp, kv))
    out = _fullseq_core(_tp_cfg(cfg, heads, kv), q, k, v, positions, impl)
    new_cache = None
    if cache is not None:
        if tp.seq_cache and not cfg.mla_kv_lora_rank:
            new_cache = _prefill_cache_seqsplit(cache, to_cache, S, tp)
        else:
            new_cache = _prefill_cache(cache, to_cache, S)
    return _tp_out(params, cfg, out, tp), new_cache


def _attention_decode_tp(params, cfg: ModelConfig, x, cache, impl, lengths,
                         positions, tp):
    if cfg.mla_kv_lora_rank and cfg.num_heads % tp.size:
        raise NotImplementedError("MLA on a mesh whose model axis does not "
                                  "divide the heads")
    seq = tp.seq_cache and not cfg.mla_kv_lora_rank
    if seq and cache["index"].dim() != 0:
        raise NotImplementedError("a sequence-split cache decodes at one "
                                  "scalar index (the reference's rule)")
    # a cache not split by heads holds every KV head: attend every head
    every = seq or (cfg.num_kv_heads % tp.size != 0
                    and not cfg.mla_kv_lora_rank)
    heads, kv = _tp_heads(cfg, tp, every)
    if cfg.mla_kv_lora_rank:
        kv = heads
    q, _, _, to_cache = _tp_project(params, cfg, x, positions, tp, heads,
                                    kv, _cache_kv_heads(cfg, tp, kv))
    if seq:
        out, k, v = decode_core_seqsharded(
            q, to_cache["k"], to_cache["v"], cache["k"], cache["v"],
            cache["index"], tp, is_ring(cfg))
        new_cache = dict(cache, k=k, v=v, index=cache["index"] + 1)
    else:
        # MLA recomputes the rank's heads from the latent: its w_ukv block
        local = params
        if cfg.mla_kv_lora_rank:
            hd = cfg.head_dim
            w = params["w_ukv"]
            if w["kernel"].shape[1] == cfg.num_heads * 2 * hd:
                lo, hi = heads[0] * 2 * hd, heads[1] * 2 * hd
                w = {n: t[..., lo:hi] for n, t in w.items()}
            local = dict(params, w_ukv=w)
        out, new_cache = _decode_core(local, _tp_cfg(cfg, heads, kv), q,
                                      cache, to_cache, positions, impl,
                                      lengths)
    return _tp_out(params, cfg, out, tp), new_cache


def decode_core_seqsharded(q, k_new, v_new, cache_k, cache_v, index, tp,
                           ring: bool):
    """The reference's ``_decode_core_seqsharded`` on one rank of the
    model axis. q: [B,1,H,Dh]; k_new/v_new: [B,1,Kv,Dh]; cache_[kv]: this
    rank's slots [r·Cl, (r+1)·Cl) of a [B,C,Kv,Dh] cache; ``index`` a
    scalar. The new row is written in place by the rank that owns its
    slot; each rank runs the softmax over its own valid slots (the ring's
    position rule under local/sliding attention), and the max, the sum
    and the weighted values are reduced over the axis (``all_reduce``
    MAX and SUM for ``pmax`` and ``psum``). Returns (out [B,1,H,Dh],
    cache_k, cache_v)."""
    B, C_loc, Kv, Dh = cache_k.shape
    C = C_loc * tp.size
    H = q.shape[2]
    g = H // Kv
    dev = q.device
    slot = index % C if ring else torch.clamp(index, max=C - 1)
    loc = slot.long() - tp.rank * C_loc
    in_range = (loc >= 0) & (loc < C_loc)
    loc_c = torch.clamp(loc, 0, C_loc - 1).reshape(1)
    for ck, new in ((cache_k, k_new), (cache_v, v_new)):
        old = ck.index_select(1, loc_c)
        ck.index_copy_(1, loc_c, torch.where(in_range, new.to(ck.dtype),
                                             old))
    slots = tp.rank * C_loc + torch.arange(C_loc, device=dev)
    idx = index.long()
    if ring:
        base = torch.div(idx - slots, C, rounding_mode="floor") * C + slots
        k_pos = torch.where(base > idx, base - C, base)
        valid = (k_pos >= 0) & (k_pos <= idx) & (idx - k_pos < C)
    else:
        valid = slots <= idx
    qh = q[:, 0].reshape(B, Kv, g, Dh)
    logits = torch.einsum("bkgd,bskd->bkgs", qh.float(),
                          cache_k.to(qh.dtype).float()) / math.sqrt(Dh)
    logits = torch.where(valid[None, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    m = tp.all_reduce(logits.amax(-1), dist.ReduceOp.MAX)
    p = torch.exp(logits - m[..., None])
    p = torch.where(valid[None, None, None], p, torch.zeros_like(p))
    l = tp.all_reduce(p.sum(-1))
    o = torch.einsum("bkgs,bskd->bkgd", p.to(cache_v.dtype), cache_v)
    o = tp.all_reduce(o.float())
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, Dh).to(q.dtype), cache_k, cache_v


# ---------------------------------------------------------------------------
# encoder self-attention and cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def encoder_self_attention(params, cfg: ModelConfig, h, positions,
                           impl: str = "xla", tp=None):
    """Bidirectional self-attention of an encoder layer: the GQA
    projections with RoPE, every position attending every other. "flash"
    and "decode_kernel" run the flash kernel with ``causal=False``, "xla"
    the plain ``_sdpa`` under an all-ones mask. ``tp``: the rank's share
    on a mesh."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn impl {impl!r} not in {ATTN_IMPLS}")
    B, S, _ = h.shape
    hd = cfg.head_dim
    if tp is not None:
        heads, kv = _tp_heads(cfg, tp)
        q, k, v, _ = _tp_project(params, cfg, h, positions, tp, heads, kv,
                                 kv)
    else:
        q = dense_apply(params["wq"], h).reshape(B, S, cfg.num_heads, hd)
        k = dense_apply(params["wk"], h).reshape(B, S, cfg.num_kv_heads, hd)
        v = dense_apply(params["wv"], h).reshape(B, S, cfg.num_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if impl == "xla":
        mask = torch.ones((S, S), dtype=torch.bool, device=h.device)
        out = _sdpa(q, k, v, mask)
    else:
        out = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=False)
    if tp is not None:
        return _tp_out(params, cfg, out, tp)
    return dense_apply(params["wo"], out.reshape(B, S, -1))


def cross_attention_init(gen, cfg: ModelConfig, dtype=torch.float32):
    """The reference's wq, wk, wv, wo, none with a bias."""
    hd = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype=dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd,
                         dtype=dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd,
                         dtype=dtype),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype=dtype),
    }


def cross_attention_apply(params, cfg: ModelConfig, x, memory,
                          impl: str = "xla", tp=None):
    """x: [B,Sq,M] decoder states; memory: [B,Sk,M] encoder output. K/V
    are projected from the whole memory at every call, as the reference
    does. One query a row (decode) under "decode_kernel" runs the dense
    decode kernel with every row's length Sk (a device tensor: a captured
    step replays it); everything else the plain ``_sdpa``. ``tp``: the
    rank's share on a mesh."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn impl {impl!r} not in {ATTN_IMPLS}")
    B, Sq, _ = x.shape
    Sk = memory.shape[1]
    hd = cfg.head_dim
    if tp is not None:
        heads, kv = _tp_heads(cfg, tp)
        q = tp_lib.take_columns(params["wq"], x, cfg.num_heads * hd,
                                heads[0] * hd, heads[1] * hd, tp)
        k = tp_lib.take_columns(params["wk"], memory, cfg.num_kv_heads * hd,
                                kv[0] * hd, kv[1] * hd, tp)
        v = tp_lib.take_columns(params["wv"], memory, cfg.num_kv_heads * hd,
                                kv[0] * hd, kv[1] * hd, tp)
        q = q.reshape(B, Sq, -1, hd)
        k, v = k.reshape(B, Sk, -1, hd), v.reshape(B, Sk, -1, hd)
    else:
        q = dense_apply(params["wq"], x).reshape(B, Sq, cfg.num_heads, hd)
        k = dense_apply(params["wk"], memory).reshape(B, Sk,
                                                      cfg.num_kv_heads, hd)
        v = dense_apply(params["wv"], memory).reshape(B, Sk,
                                                      cfg.num_kv_heads, hd)
    if impl == "decode_kernel" and Sq == 1:
        lengths = torch.full((B,), Sk, dtype=torch.int32, device=x.device)
        out = dec_ops.decode_attention(q[:, 0].contiguous(), k.contiguous(),
                                       v.contiguous(), lengths)[:, None]
    else:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask)
    if tp is not None:
        return _tp_out(params, cfg, out, tp)
    return dense_apply(params["wo"], out.reshape(B, Sq, -1))
