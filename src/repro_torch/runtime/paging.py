"""Paged KV cache with shared-prefix reuse (PyTorch counterpart of
``repro.runtime.paging``): the block-granular memory subsystem under the
serving path.

The dense ``KVCacheManager`` preallocates ``num_slots`` rows of
``max_context`` KV positions, so concurrency is capped by the WORST-CASE
context. This module replaces that layout with fixed-size blocks
(vLLM's PagedAttention layout):

  ``BlockPool``      physical pages ``[num_blocks, block_size, Kv, D]``
                     per layer, a free-list + per-page refcounts, and
                     watermark accounting. ONE pool indexes every layer:
                     page p of layer t's arrays belongs to the same
                     logical block as page p of every other layer, so a
                     single block table serves the whole model.
  ``PrefixCache``    content-hash reuse: full prefill blocks are keyed
                     by a sha256 chain over their token chunks, so N
                     requests sharing a system prompt map their prefix
                     logical blocks to the SAME physical pages
                     (refcounted). Pages at refcount 0 stay cached
                     ("reclaimable") and are evicted LRU only under pool
                     pressure.
  ``PagedKVCacheManager``
                     drop-in ``KVCacheManager``: same slot/ledger API,
                     but each slot holds a block table (int row of
                     physical page ids) instead of a dense cache row.
                     ``table_array()`` is the int32 tensor the paged
                     decode kernel reads its page chains from (one
                     tensor, refilled in place after a table change).

The ledger (pool, prefix cache, tables, admission and watermarks) is a
copy of the reference's and is held against it by the tests. The cache
surgery is torch, and writes IN PLACE: ``merge_prefill`` copies only the
non-cached pages into the pools with ``index_copy_`` on the page axis,
where the reference builds new arrays with ``.at[].set``.

Copy-on-write is BY CONSTRUCTION rather than by fault: only FULL prefill
blocks (the first ``Lp // block_size``) are hashed and shared, and they
are immutable — decode appends at positions >= Lp, which always land in
a private tail page. A shared page is therefore never written after its
copy, and divergence after a common prefix lands in fresh pages without
any copy needing to happen.

Page 0 of the pool is reserved as a scratch sink: dead batch rows in the
vectorized decode scatter clamp their (unallocated, -1) table entries to
it, so they never corrupt a live page.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.runtime.decode_graph import StagedBuffer
from repro_torch.runtime.kv import KVCacheManager
from repro_torch.sched.occupancy import OccupancySummary

#: reserved scratch page (see module docstring)
SCRATCH_PAGE = 0


@dataclass
class PagingStats:
    """Telemetry counters the engine/benchmarks surface."""

    prefix_hit_tokens: int = 0      # prefill tokens served from shared pages
    prefix_miss_tokens: int = 0     # prefill tokens that streamed fresh
    prefix_hit_blocks: int = 0
    prefix_inserted_blocks: int = 0
    prefix_reclaimed_blocks: int = 0
    preemptions: int = 0            # slots evicted-to-recompute by engine

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefix_hit_tokens + self.prefix_miss_tokens
        return self.prefix_hit_tokens / total if total else 0.0

    def reset(self) -> None:
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.prefix_hit_blocks = 0
        self.prefix_inserted_blocks = 0
        self.prefix_reclaimed_blocks = 0
        self.preemptions = 0


class BlockPool:
    """Fixed-size physical KV pages: free-list allocation + per-page
    refcounts. The pool tracks PAGES, not contents — sharing policy
    (which pages are reclaimable instead of freed) lives in the caller.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("BlockPool needs >= 2 blocks "
                             "(page 0 is the reserved scratch sink)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # pop() serves the lowest page first — deterministic layouts
        self._free = list(range(num_blocks - 1, SCRATCH_PAGE, -1))
        self._ref = [0] * num_blocks
        self._ref[SCRATCH_PAGE] = 1          # never allocated, never freed
        self.allocs = 0
        self.frees = 0
        self.peak_used = 0

    # -- accounting --------------------------------------------------------
    @property
    def usable(self) -> int:
        """Pages that can hold KV (everything but the scratch page)."""
        return self.num_blocks - 1

    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        """Pages off the free list (live + reclaimable-cached)."""
        return self.usable - len(self._free)

    def ref(self, page: int) -> int:
        return self._ref[page]

    # -- alloc / refcount lifecycle ---------------------------------------
    def alloc(self) -> Optional[int]:
        """Claim a fresh page at refcount 1 (None when the free list is
        empty — the caller may then reclaim a cached page and ``adopt``
        it)."""
        if not self._free:
            return None
        page = self._free.pop()
        assert self._ref[page] == 0
        self._ref[page] = 1
        self.allocs += 1
        self.peak_used = max(self.peak_used, self.used_count())
        return page

    def adopt(self, page: int) -> int:
        """Re-claim a reclaimable page (refcount 0, off the free list) —
        the prefix cache evicted it and hands the page over."""
        assert self._ref[page] == 0 and page not in self._free
        self._ref[page] = 1
        self.allocs += 1
        return page

    def retain(self, page: int) -> int:
        assert self._ref[page] > 0, f"retain of unreferenced page {page}"
        self._ref[page] += 1
        return page

    def release(self, page: int) -> int:
        """Drop one reference; returns the remaining count. The caller
        decides what a 0 means: ``free`` (private page) or keep-cached
        (prefix page, reclaimable)."""
        assert self._ref[page] > 0, f"release of unreferenced page {page}"
        self._ref[page] -= 1
        return self._ref[page]

    def free(self, page: int) -> None:
        """Return an unreferenced page to the free list."""
        assert page != SCRATCH_PAGE and self._ref[page] == 0
        self._free.append(page)
        self.frees += 1

    def check_invariants(self) -> None:
        """Structural soundness of the page ledger; raises
        ``AssertionError`` listing every broken invariant. Cheap (O(pages))
        — test teardowns call this after every scenario so a refcount
        leak surfaces at the scenario that caused it, not three tests
        later as an inexplicable pool exhaustion."""
        problems: List[str] = []
        if self._ref[SCRATCH_PAGE] < 1:
            problems.append(
                f"scratch page {SCRATCH_PAGE} refcount "
                f"{self._ref[SCRATCH_PAGE]} < 1 (must stay pinned)")
        if SCRATCH_PAGE in self._free:
            problems.append(f"scratch page {SCRATCH_PAGE} is on the "
                            f"free list")
        if len(set(self._free)) != len(self._free):
            dupes = sorted({p for p in self._free
                            if self._free.count(p) > 1})
            problems.append(f"free list has duplicate pages {dupes} "
                            f"(double free)")
        for p in self._free:
            if not 0 <= p < self.num_blocks:
                problems.append(f"free page {p} outside "
                                f"[0, {self.num_blocks})")
            elif self._ref[p] != 0:
                problems.append(f"free page {p} has refcount "
                                f"{self._ref[p]} != 0")
        for p, r in enumerate(self._ref):
            if r < 0:
                problems.append(f"page {p} refcount {r} < 0")
        if self.used_count() + self.free_count() != self.usable:
            problems.append(
                f"page accounting broken: used {self.used_count()} + "
                f"free {self.free_count()} != usable {self.usable}")
        if problems:
            raise AssertionError("BlockPool invariants violated:\n  "
                                 + "\n  ".join(problems))

    def __repr__(self) -> str:
        return (f"BlockPool(used={self.used_count()}/{self.usable}, "
                f"block_size={self.block_size})")


def chunk_keys(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """sha256 chain over full token chunks: key_l commits to the WHOLE
    prefix up to block l, so equal keys imply equal logical contents
    (the KV of a position depends on every position before it). Partial
    tail chunks get no key — only full blocks are shareable. A content
    hash (not Python's randomized ``hash``) so keys are stable across
    processes and collision-safe at serving scale."""
    keys: List[bytes] = []
    h = b""
    arr = np.asarray(list(tokens), np.int64)
    for l in range(len(arr) // block_size):
        m = hashlib.sha256()
        m.update(h)
        m.update(arr[l * block_size:(l + 1) * block_size].tobytes())
        h = m.digest()
        keys.append(h)
    return keys


class PrefixCache:
    """key -> physical page map with refcount-aware retention.

    A page stays mapped while referenced; when its last reference drops
    it becomes RECLAIMABLE (kept mapped, parked in an LRU) instead of
    freed — the next request with the same prefix re-shares it for free.
    Pool pressure evicts reclaimable pages oldest-first via ``reclaim``.
    """

    def __init__(self):
        self._page_by_key: Dict[bytes, int] = {}
        self._key_by_page: Dict[int, bytes] = {}
        self._reclaimable: "OrderedDict[int, None]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._page_by_key)

    def reclaimable_count(self) -> int:
        return len(self._reclaimable)

    def lookup(self, key: bytes) -> Optional[int]:
        return self._page_by_key.get(key)

    def key_of(self, page: int) -> Optional[bytes]:
        return self._key_by_page.get(page)

    def insert(self, key: bytes, page: int) -> None:
        assert key not in self._page_by_key
        self._page_by_key[key] = page
        self._key_by_page[page] = key

    def on_retained(self, page: int) -> None:
        """Page gained a reference — no longer parked."""
        self._reclaimable.pop(page, None)

    def on_released(self, page: int) -> None:
        """Page hit refcount 0 but stays cached for future prefix hits."""
        assert page in self._key_by_page
        self._reclaimable[page] = None
        self._reclaimable.move_to_end(page)

    def reclaim(self) -> Optional[int]:
        """Evict the least-recently-parked refcount-0 page: drops its key
        so future lookups miss, and hands the page back for ``adopt``."""
        if not self._reclaimable:
            return None
        page, _ = self._reclaimable.popitem(last=False)
        key = self._key_by_page.pop(page)
        del self._page_by_key[key]
        return page

    def drop(self, page: int) -> None:
        """Unmap a page without reclaiming it — the rollback path for an
        ``insert`` whose contents never got written (a later allocation
        in the same assignment exhausted the pool). A dropped page must
        not be findable: a hit would share garbage KV."""
        key = self._key_by_page.pop(page, None)
        if key is not None:
            del self._page_by_key[key]
        self._reclaimable.pop(page, None)

    def __repr__(self) -> str:
        return (f"PrefixCache(entries={len(self)}, "
                f"reclaimable={self.reclaimable_count()})")


class PagedKVCacheManager(KVCacheManager):
    """``KVCacheManager`` with block-granular storage.

    Same slot/ledger surface (the engine's bookkeeping is unchanged);
    underneath, each slot maps its logical blocks to pool pages through a
    ``[num_slots, max_blocks]`` table, attention-layer caches are page
    pools ``[num_blocks, block_size, Kv, D]``, and ``merge_prefill``
    scatters prefill rows page-by-page — skipping pages served by the
    prefix cache. ``model=None`` still gives a ledger-only manager
    (tables/pool/prefix fully functional, no device arrays) for tests
    and capacity benchmarks.
    """

    def __init__(self, num_slots: int, max_context: int, model=None,
                 dtype=None, *, block_size: int = 32,
                 num_blocks: Optional[int] = None,
                 watermark_high: float = 0.90,
                 watermark_low: float = 0.75):
        super().__init__(num_slots, max_context, model=model, dtype=dtype)
        if not 0.0 < watermark_low <= watermark_high <= 1.0:
            raise ValueError("need 0 < watermark_low <= watermark_high <= 1")
        self.block_size = int(block_size)
        self.max_blocks = math.ceil(max_context / self.block_size)
        if num_blocks is None:
            # parity default: the same footprint as the dense layout
            num_blocks = num_slots * self.max_blocks + 1
        self.pool = BlockPool(num_blocks, self.block_size)
        self.prefix = PrefixCache()
        self.paging = PagingStats()
        self.watermark_high = float(watermark_high)
        self.watermark_low = float(watermark_low)
        self._throttled = False
        self._tables = np.full((num_slots, self.max_blocks), -1, np.int32)
        self._nblk = [0] * num_slots         # allocated logical blocks/slot
        # the decode step's device table, one tensor for the manager's life
        # (a captured step reads it in place), refilled after a change
        self._table_buf = StagedBuffer(self._tables.shape, torch.int32,
                                       self._device())
        self._table_dirty = True

    # ------------------------------------------------------------------
    # pool pressure / watermarks
    # ------------------------------------------------------------------
    def blocks_free(self) -> int:
        """Pages an allocation can obtain: free-list + reclaimable."""
        return self.pool.free_count() + self.prefix.reclaimable_count()

    def utilization(self) -> float:
        """Fraction of usable pages pinned by live references (cached
        reclaimable pages don't count — they yield under pressure)."""
        return 1.0 - self.blocks_free() / max(self.pool.usable, 1)

    def admission_blocked(self) -> bool:
        """Watermark hysteresis: once utilization crosses HIGH, admission
        stays off until it falls back under LOW (prevents admit/preempt
        thrash at the boundary)."""
        u = self.utilization()
        if self._throttled:
            if u <= self.watermark_low:
                self._throttled = False
        elif u >= self.watermark_high:
            self._throttled = True
        return self._throttled

    # ------------------------------------------------------------------
    # page allocation
    # ------------------------------------------------------------------
    def _alloc_page(self) -> Optional[int]:
        page = self.pool.alloc()
        if page is None:
            reclaimed = self.prefix.reclaim()
            if reclaimed is None:
                return None
            self.paging.prefix_reclaimed_blocks += 1
            page = self.pool.adopt(reclaimed)
        return page

    def _release_page(self, page: int) -> None:
        if self.pool.release(page) == 0:
            if self.prefix.key_of(page) is not None:
                self.prefix.on_released(page)    # park, don't free
            else:
                self.pool.free(page)

    def _release_slot_pages(self, slot: int) -> None:
        for l in range(self._nblk[slot]):
            self._release_page(int(self._tables[slot, l]))
        self._tables[slot, :] = -1
        self._nblk[slot] = 0
        self._table_dirty = True

    # ------------------------------------------------------------------
    # slot lifecycle overrides
    # ------------------------------------------------------------------
    def free(self, slot: int) -> None:
        self._release_slot_pages(slot)
        super().free(slot)

    # ------------------------------------------------------------------
    # admission probing (BatchScheduler)
    # ------------------------------------------------------------------
    def blocks_for_tokens(self, n_prefill_tokens: int) -> int:
        """Logical blocks a request with ``Lp`` prefill tokens needs at
        admission: positions 0..Lp inclusive (the fed-through last prompt
        token writes position Lp on its first decode step)."""
        return max(n_prefill_tokens, 0) // self.block_size + 1

    def cached_prefix_tokens(self, tokens: Sequence[int]) -> int:
        """Longest shared prefix (whole blocks, chain order) already
        resident — probe only, no refcounts taken."""
        hits = 0
        for key in chunk_keys(tokens, self.block_size):
            if self.prefix.lookup(key) is None:
                break
            hits += 1
        return hits * self.block_size

    def admission_charge(self, tokens: Sequence[int]) -> Tuple[int, int]:
        """(new_pages, cached_tokens) admitting ``tokens`` would cost —
        the scheduler charges block budget for new pages only and prefill
        token budget for non-cached tokens only."""
        cached = self.cached_prefix_tokens(tokens)
        total = self.blocks_for_tokens(len(tokens))
        return total - cached // self.block_size, cached

    # ------------------------------------------------------------------
    # block-table construction (prefill admission)
    # ------------------------------------------------------------------
    def assign_blocks(self, slot: int, tokens: Sequence[int]
                      ) -> List[Tuple[int, int, bool]]:
        """Map ``slot``'s logical blocks for a prefill of ``tokens`` to
        physical pages: shared pages for the cached prefix chain, fresh
        pages beyond it; full fresh blocks are registered for future
        sharing. Returns [(logical, page, cached)] — ``cached`` pages
        already hold their contents and must NOT be written.

        Raises ``RuntimeError`` on pool exhaustion after rolling the
        partial assignment back (admission charged capacity, so this is
        a bookkeeping bug or an over-admitting custom policy)."""
        assert self._nblk[slot] == 0, f"slot {slot} already has pages"
        tokens = list(tokens)
        n_blocks = self.blocks_for_tokens(len(tokens))
        keys = chunk_keys(tokens, self.block_size)
        out: List[Tuple[int, int, bool]] = []
        try:
            for l in range(n_blocks):
                # chain keys commit to the full prefix, so a hit after a
                # miss (middle page reclaimed, later page still cached)
                # is still content-correct and worth sharing
                page = self.prefix.lookup(keys[l]) if l < len(keys) else None
                if page is not None:
                    if self.pool.ref(page) == 0:
                        self.pool.adopt(page)    # revive a parked page
                    else:
                        self.pool.retain(page)
                    self.prefix.on_retained(page)
                    self.paging.prefix_hit_blocks += 1
                    cached = True
                else:
                    page = self._alloc_page()
                    if page is None:
                        raise RuntimeError(
                            "BlockPool exhausted during assign_blocks "
                            "(admission over-committed)")
                    cached = False
                    if l < len(keys):    # full fresh block: shareable
                        self.prefix.insert(keys[l], page)
                        self.paging.prefix_inserted_blocks += 1
                self._tables[slot, l] = page
                self._nblk[slot] = l + 1
                out.append((l, page, cached))
        except RuntimeError:
            # fresh full blocks were registered before their contents
            # were scattered; unmap them so no future request hits a
            # page that never got written
            for _, page, cached in out:
                if not cached:
                    self.prefix.drop(page)
            self._release_slot_pages(slot)
            raise
        hit_tokens = sum(self.block_size for _, _, c in out if c)
        self.paging.prefix_hit_tokens += hit_tokens
        self.paging.prefix_miss_tokens += max(len(tokens) - hit_tokens, 0)
        self._table_dirty = True
        return out

    # ------------------------------------------------------------------
    # decode growth (engine, before each decode step)
    # ------------------------------------------------------------------
    def missing_decode_page(self, slot: int) -> bool:
        """Does the next decode write (position ledger-1) lack a page?"""
        write_pos = max(self._lengths[slot] - 1, 0)
        return write_pos // self.block_size >= self._nblk[slot]

    def ensure_decode_page(self, slot: int) -> bool:
        """Allocate the tail page the next decode write needs; False on
        pool exhaustion (the engine preempts a victim and retries)."""
        if not self.missing_decode_page(slot):
            return True
        page = self._alloc_page()
        if page is None:
            return False
        l = self._nblk[slot]
        self._tables[slot, l] = page
        self._nblk[slot] = l + 1
        self._table_dirty = True
        return True

    # ------------------------------------------------------------------
    # whole-ledger invariants (test teardowns, debugging)
    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Cross-check the three ledgers against each other — pool
        refcounts vs block-table references vs prefix-cache parking.
        Raises ``AssertionError`` listing every broken invariant. Called
        by test teardowns after every paging scenario: a leak or double
        free surfaces at the scenario that caused it."""
        self.pool.check_invariants()
        problems: List[str] = []
        table_refs: Dict[int, int] = {}
        for slot in range(self.num_slots):
            n = self._nblk[slot]
            for l in range(self.max_blocks):
                page = int(self._tables[slot, l])
                if l < n:
                    if not 0 <= page < self.pool.num_blocks:
                        problems.append(
                            f"slot {slot} block {l}: page {page} outside "
                            f"[0, {self.pool.num_blocks})")
                        continue
                    if page == SCRATCH_PAGE:
                        problems.append(
                            f"slot {slot} block {l} maps the reserved "
                            f"scratch page {SCRATCH_PAGE}")
                        continue
                    table_refs[page] = table_refs.get(page, 0) + 1
                elif page != -1:
                    problems.append(
                        f"slot {slot} block {l} beyond nblk={n} holds "
                        f"{page}, expected -1 (stale mapping)")
            write_block = max(self._lengths[slot] - 1, 0) // self.block_size
            if self._live[slot] and write_block > n:
                problems.append(
                    f"slot {slot} length {self._lengths[slot]} writes "
                    f"block {write_block} but only {n} blocks are mapped "
                    f"(more than the one decode-growth page missing)")
        for page, refs in sorted(table_refs.items()):
            if self.pool.ref(page) != refs:
                problems.append(
                    f"page {page}: {refs} table reference(s) but pool "
                    f"refcount {self.pool.ref(page)} (leak or double "
                    f"free)")
            if page in self.pool._free:
                problems.append(f"page {page} is mapped by a table AND "
                                f"on the free list")
        for page in range(1, self.pool.num_blocks):
            if self.pool.ref(page) > 0 and page not in table_refs:
                problems.append(
                    f"page {page} refcount {self.pool.ref(page)} but no "
                    f"table maps it (leaked reference)")
        # prefix-cache bijection + parked-page discipline
        for key, page in self.prefix._page_by_key.items():
            if self.prefix._key_by_page.get(page) != key:
                problems.append(f"prefix cache maps key->page {page} but "
                                f"page->key disagrees")
        for page in self.prefix._reclaimable:
            if self.prefix.key_of(page) is None:
                problems.append(f"parked page {page} has no prefix key")
            if self.pool.ref(page) != 0:
                problems.append(
                    f"parked page {page} has refcount "
                    f"{self.pool.ref(page)} != 0 (parked means idle)")
            if page in self.pool._free:
                problems.append(f"parked page {page} is also on the "
                                f"free list")
        if problems:
            raise AssertionError(
                "PagedKVCacheManager invariants violated:\n  "
                + "\n  ".join(problems))

    # ------------------------------------------------------------------
    # cache surgery (paged layout)
    # ------------------------------------------------------------------
    def ensure_caches(self) -> None:
        if self.caches is not None:
            return
        if self.model is None:
            raise ValueError("ledger-only PagedKVCacheManager (model=None) "
                             "holds no caches")
        # one page pool per layer, by initializing the model's cache with
        # batch=num_blocks, context=block_size: [P, bs, Kv, D] per array.
        # Page p means the same logical block in every layer, so a single
        # block table drives the whole model.
        caches = self.model.init_cache(self.pool.num_blocks,
                                       self.block_size, dtype=self.dtype)
        paged = []
        for c in caches:
            if isinstance(c, dict) and "index" in c:
                paged.append(dict(c, index=torch.zeros(
                    (self.num_slots,), dtype=torch.int32,
                    device=c["index"].device)))
            else:
                raise ValueError(
                    "paged KV requires full-attention layer caches "
                    f"(got {type(c).__name__}); gate kv_layout='paged' "
                    "on a supported model")
        self.caches = paged

    def _device(self) -> torch.device:
        if self.caches is not None:
            return self.caches[0]["index"].device
        if self.model is not None:
            return self.model.device
        return torch.device("cpu")

    def table_array(self) -> torch.Tensor:
        """The [num_slots, max_blocks] int32 block table the decode
        step's kernel reads: the same tensor at every call, refilled from
        the host tables (pinned, asynchronously) only after they change."""
        if self._table_dirty:
            self._table_buf.load(self._tables)
            self._table_dirty = False
        return self._table_buf.tensor

    def merge_prefill(self, slots: Sequence[int], prefilled: List[Any],
                      lengths: Sequence[int],
                      tokens: Sequence[Sequence[int]]) -> None:
        """Paged merge: assign each slot's block table (sharing cached
        prefix pages), then copy the batched-prefill rows into the
        NON-cached pages of every layer. ``tokens[j]`` are row j's real
        prefill token ids — the prefix-cache key material."""
        if self.model is not None:
            self.ensure_caches()
        assignments = []
        for j, slot in enumerate(slots):
            toks = list(tokens[j])
            assert len(toks) == int(lengths[j]), (len(toks), lengths[j])
            assignments.append(self.assign_blocks(slot, toks))

        if self.model is not None:
            self._scatter_prefill(slots, prefilled, lengths, assignments)
        for slot, n in zip(slots, lengths):
            self.set_length(slot, int(n) + 1)

    def _assign_private(self, slot: int, n_prefill_tokens: int
                        ) -> List[Tuple[int, int, bool]]:
        """A private block table, no prefix sharing (``reset_slot``'s
        single page)."""
        assert self._nblk[slot] == 0
        out = []
        for l in range(self.blocks_for_tokens(n_prefill_tokens)):
            page = self._alloc_page()
            if page is None:
                self._release_slot_pages(slot)
                raise RuntimeError("BlockPool exhausted during "
                                   "_assign_private")
            self._tables[slot, l] = page
            self._nblk[slot] = l + 1
            out.append((l, page, False))
        self.paging.prefix_miss_tokens += max(n_prefill_tokens, 0)
        self._table_dirty = True
        return out

    def _scatter_prefill(self, slots, prefilled, lengths, assignments):
        """Copy each row's fresh (non-cached) blocks into their pages, in
        place: one ``index_copy_`` on the page axis per layer array."""
        bs = self.block_size
        dev = self._device()
        ix = torch.as_tensor(list(slots), dtype=torch.long, device=dev)
        lens = torch.as_tensor([int(n) for n in lengths], dtype=torch.int32,
                               device=dev)
        page_ids: List[int] = []
        rows: List[Tuple[int, List[int]]] = []
        for j, assignment in enumerate(assignments):
            fresh = [l for l, _, cached in assignment if not cached]
            if fresh:
                page_ids.extend(int(assignment[l][1]) for l in fresh)
                rows.append((j, fresh))
        pages_ix = torch.as_tensor(page_ids, dtype=torch.long, device=dev)
        for c_all, c_new in zip(self.caches, prefilled):
            c_all["index"].index_copy_(0, ix, lens)
            if not page_ids:
                continue
            for name, pages in c_all.items():
                if name == "index":
                    continue
                blocks = []
                for j, fresh in rows:
                    row = c_new[name][j]                # [bucket, Kv, D]
                    n_l = len(assignments[j])
                    pad = n_l * bs - row.shape[0]
                    if pad > 0:
                        row = torch.cat([row, row.new_zeros(
                            (pad,) + tuple(row.shape[1:]))])
                    row = row[:n_l * bs].reshape((n_l, bs) + row.shape[1:])
                    blocks.append(row[torch.as_tensor(fresh, device=dev)])
                pages.index_copy_(0, pages_ix,
                                  torch.cat(blocks).to(pages.dtype))

    def reset_slot(self, slot: int) -> None:
        """Zero-prefill path: fresh single private page, index 0."""
        self._release_slot_pages(slot)
        assignment = self._assign_private(slot, 0)
        assert len(assignment) == 1
        if self.model is not None:
            self.ensure_caches()
            for c in self.caches:
                c["index"][slot] = 0
        self.set_length(slot, 1)

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def occupancy(self) -> OccupancySummary:
        return OccupancySummary.from_lengths(
            (self._lengths[s] for s in self.live_slots()),
            max_bucket=self.max_context,
            block_pressure=self.utilization())

    def paging_summary(self) -> Dict[str, float]:
        """One flat dict for engine stats / benchmark rows."""
        p = self.paging
        return {
            "block_size": self.block_size,
            "blocks_usable": self.pool.usable,
            "blocks_used": self.pool.used_count(),
            "blocks_free": self.blocks_free(),
            "blocks_reclaimable": self.prefix.reclaimable_count(),
            "utilization": self.utilization(),
            "peak_blocks_used": self.pool.peak_used,
            "prefix_entries": len(self.prefix),
            "prefix_hit_tokens": p.prefix_hit_tokens,
            "prefix_miss_tokens": p.prefix_miss_tokens,
            "prefix_hit_rate": p.prefix_hit_rate,
            "prefix_hit_blocks": p.prefix_hit_blocks,
            "prefix_reclaimed_blocks": p.prefix_reclaimed_blocks,
            "preemptions": p.preemptions,
        }

    def __repr__(self) -> str:
        return (f"PagedKVCacheManager(slots={self.live_count()}/"
                f"{self.num_slots}, {self.pool!r}, "
                f"hit_rate={self.paging.prefix_hit_rate:.2f})")
