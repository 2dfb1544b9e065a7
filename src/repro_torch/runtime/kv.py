"""KV/occupancy manager (PyTorch counterpart of ``repro.runtime.kv``): slot
allocation, the per-slot context-length ledger, and the engine's layer-cache
surgery (init / batched-prefill merge / reset).

Cache layout, one entry per layer (mirroring ``Model.init_cache``):
  * attention caches are dicts ``{"k": [slots,C,Kv,D], "v": ...,
    "index": int32 [slots]}`` (MLA: ``{"ckv": [slots,C,r], "kpe":
    [slots,C,D], "index"}``) — the per-slot index is each slot's
    continuous-batching position; the surgery below loops over a cache's
    tensors, whatever their names;
  * recurrent (mLSTM/sLSTM) states are dicts of per-slot float32 state
    rows, with no index.
Unlike the JAX package, which builds new arrays with ``.at[].set``, this
manager writes rows IN PLACE with ``index_copy_``: the per-slot caches are
allocated once and never copied. Eviction is ledger-only: stale rows are
masked by the lengths (attention) or overwritten by the next prefill.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import torch

from repro_torch.sched.occupancy import OccupancySummary


@dataclass
class KVStats:
    allocs: int = 0
    frees: int = 0
    peak_live: int = 0


class KVCacheManager:
    def __init__(self, num_slots: int, max_context: int, model=None,
                 dtype=None):
        self.num_slots = num_slots
        self.max_context = max_context
        self.model = model
        # KV dtype; recurrent states stay float32 whatever this is
        self.dtype = dtype if dtype is not None else getattr(model, "dtype",
                                                             None)
        self.caches: Optional[List[Any]] = None
        self._live = [False] * num_slots
        # context length per live slot: prompt tokens + generated tokens,
        # i.e. the KV positions the NEXT decode step attends over
        self._lengths = [0] * num_slots
        self.stats = KVStats()

    # ------------------------------------------------------------------
    # slot allocation / ledger
    # ------------------------------------------------------------------
    def alloc(self) -> Optional[int]:
        """Claim the lowest free slot (None when full)."""
        for slot in range(self.num_slots):
            if not self._live[slot]:
                return self.take(slot)
        return None

    def take(self, slot: int) -> int:
        """Claim a specific slot (must be free)."""
        if self._live[slot]:
            raise ValueError(f"slot {slot} is already live")
        self._live[slot] = True
        self._lengths[slot] = 0
        self.stats.allocs += 1
        self.stats.peak_live = max(self.stats.peak_live, self.live_count())
        return slot

    def free(self, slot: int) -> None:
        """Evict a slot (ledger-only)."""
        if not self._live[slot]:
            raise ValueError(f"slot {slot} is not live")
        self._live[slot] = False
        self._lengths[slot] = 0
        self.stats.frees += 1

    def live_slots(self) -> List[int]:
        return [s for s in range(self.num_slots) if self._live[s]]

    def live_count(self) -> int:
        return sum(self._live)

    def free_count(self) -> int:
        return self.num_slots - self.live_count()

    def length(self, slot: int) -> int:
        return self._lengths[slot]

    def lengths(self) -> List[int]:
        """Per-slot context lengths (0 for dead slots) — the [num_slots]
        vector the decode step feeds to ragged attention."""
        return list(self._lengths)

    def set_length(self, slot: int, n: int) -> None:
        self._lengths[slot] = int(n)

    def note_decode(self, slots: Sequence[int]) -> None:
        """Each decoded token extends its slot's context by one."""
        for s in slots:
            self._lengths[s] += 1

    def occupancy(self) -> OccupancySummary:
        """The live decode composition."""
        return OccupancySummary.from_lengths(
            (self._lengths[s] for s in self.live_slots()),
            max_bucket=self.max_context)

    # ------------------------------------------------------------------
    # cache surgery (requires a model)
    # ------------------------------------------------------------------
    def ensure_caches(self) -> None:
        if self.caches is not None:
            return
        if self.model is None:
            raise ValueError("ledger-only KVCacheManager (model=None) "
                             "holds no caches")
        caches = self.model.init_cache(self.num_slots, self.max_context,
                                       dtype=self.dtype)
        # scalar prefill index -> per-slot index vector
        self.caches = [
            dict(c, index=torch.zeros((self.num_slots,), dtype=torch.int32,
                                      device=c["index"].device))
            if "index" in c else c
            for c in caches]

    def merge_prefill(self, slots: Sequence[int], prefilled: List[Any],
                      lengths: Sequence[int], tokens=None) -> None:
        """Copy a batched-prefill cache (row j of ``prefilled``) into slot
        row ``slots[j]`` in place; ``lengths[j]`` is the number of real
        (unpadded) prompt tokens row j holds, which becomes the slot's
        cache index. Recurrent states copy their rows the same way (they
        have no index). The ledger records lengths[j] + 1: the last prompt
        token is fed through the next decode step. ``tokens`` (the rows'
        token ids) key the paged layout's prefix cache; the dense layout
        has none and ignores them."""
        self.ensure_caches()
        dev = self.model.device
        ix = torch.as_tensor(list(slots), dtype=torch.long, device=dev)
        lens = torch.as_tensor(list(lengths), dtype=torch.int32, device=dev)
        for c_all, c_new in zip(self.caches, prefilled):
            for name, arr in c_all.items():
                if name == "index":
                    arr.index_copy_(0, ix, lens)
                else:
                    arr.index_copy_(0, ix, c_new[name].to(arr.dtype))
        for slot, n in zip(slots, lengths):
            self.set_length(slot, int(n) + 1)

    def reset_slot(self, slot: int) -> None:
        """Zero-prefill path (empty / single-token prompt): reset the
        slot's cache index so decode starts writing at position 0.
        Recurrent states are left as they are, as the reference does: a
        one-token prompt decodes from the slot's previous state."""
        self.ensure_caches()
        for c in self.caches:
            if "index" in c:
                c["index"][slot] = 0
        self.set_length(slot, 1)

    def __repr__(self) -> str:
        return (f"KVCacheManager(slots={self.live_count()}/{self.num_slots}"
                f", max_context={self.max_context}, "
                f"occupancy={self.occupancy()!r})")
