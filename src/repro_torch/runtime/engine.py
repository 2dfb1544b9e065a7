"""Continuous-batching serving engine (PyTorch counterpart of
``repro.runtime.engine`` with no plan policy): a thin loop over the
batch/KV runtime objects. Each iteration is

  1. ``BatchScheduler.build_step(waiting, kv)``: reject oversized
     prompts, admit under the admission policy, allocate KV slots, group
     admitted requests by padded prefill bucket;
  2. one batched ``model.prefill`` per ``PrefillGroup``, copied into the
     per-slot caches by the ``KVCacheManager``;
  3. under ``kv_layout="paged"``, a tail page for every live slot's next
     KV write, preempting the cheapest-to-recompute slot when the pool is
     exhausted;
  4. one decode step over the full slot batch (``runtime/decode_graph``:
     ``Model.decode_step``, per-slot temperature/top-k sampling), fed from
     static buffers; finished slots are evicted.

On a CUDA device the decode step is a CUDA graph, captured once per
static key and replayed at every step: the counterpart of the reference's
jitted decode. ``decode_graph=False`` runs the same step function eagerly
(the CPU always does). The engine runs on one device with
``moe_impl="capacity"``, over dense or paged KV (``runtime/paging.py``);
recurrent (ssm and hybrid) models keep per-slot states and prefill by
exact prompt length. The planner (``PlanCache`` and policies), expert
placement, profiling and observability are ROADMAP items of later slices
and are not accepted as arguments.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch import DeviceLike, generator_for, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.transformer import ExecutionContext
from repro_torch.runtime.batching import BatchScheduler, PrefillGroup, StepPlan
from repro_torch.runtime.decode_graph import (GRAPH_KEYS, CudaGraph,
                                              DecodeGraphs, GraphKey,
                                              StagedBuffer, bind_step)
from repro_torch.runtime.kv import KVCacheManager
from repro_torch.runtime.paging import PagedKVCacheManager
from repro_torch.runtime.request import Request, RequestState
from repro_torch.sched.occupancy import bucket_length


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    steps: int = 0
    prefill_calls: int = 0
    # wall time of the model calls, each ending in a device sync
    prefill_s: float = 0.0
    decode_s: float = 0.0
    # CUDA graphs of the decode step: captures (at most one per key) and
    # replays (one per decode step), and the wall time of the warm-up and
    # the captures (a capture runs inside its step, so also in decode_s)
    graph_captures: int = 0
    graph_replays: int = 0
    graph_s: float = 0.0


class ServingEngine:
    """``device=None`` means the CUDA card and raises without one; the
    tests pass ``device="cpu"``. ``dtype`` is the compute and KV dtype
    (the weights are drawn in it when ``params`` is None).
    ``kv_layout="paged"`` stores KV in pages of ``kv_block_size``
    positions (``kv_num_blocks`` pages, default the dense footprint)
    with prefix sharing, watermark admission (the manager's 0.90 / 0.75
    hysteresis) and preemption by recompute; it needs a full-attention
    GQA dense or moe model. ``decode_graph`` runs the decode step as a
    CUDA graph: None means on for a CUDA device and off on the CPU, True
    on the CPU raises, False runs the step eagerly."""

    def __init__(self, cfg: ModelConfig, params=None, *, num_slots: int = 4,
                 max_context: int = 4096,
                 scheduler: Optional[BatchScheduler] = None,
                 admission: str = "fcfs",
                 token_budget: Optional[int] = None,
                 attn_impl: str = "decode_kernel",
                 kv_layout: str = "dense",
                 kv_block_size: int = 32,
                 kv_num_blocks: Optional[int] = None,
                 dtype=torch.float32, seed: int = 0,
                 device: DeviceLike = None,
                 decode_graph: Optional[bool] = None):
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        if decode_graph and not cuda:
            raise ValueError(f"decode_graph=True needs a CUDA device, not "
                             f"{self.device}")
        self.decode_graph = cuda if decode_graph is None else decode_graph
        self.cfg = cfg
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout={kv_layout!r}; "
                             "choose 'dense' or 'paged'")
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        if self._paged:
            # paged decode writes and streams through a block table; ring
            # windows, MLA latent caches and recurrent states have no
            # block-granular layout
            if (cfg.attention != "full" or cfg.mla_kv_lora_rank
                    or cfg.family not in ("dense", "moe")):
                raise ValueError(
                    "kv_layout='paged' requires a full-attention GQA "
                    f"decoder (family={cfg.family!r}, "
                    f"attention={cfg.attention!r}, "
                    f"mla={cfg.mla_kv_lora_rank})")
        ctx = ExecutionContext(attn_impl=attn_impl, moe_impl="capacity")
        self.model = build_model(cfg, ctx=ctx, dtype=dtype,
                                 device=self.device)
        self.params = params if params is not None else self.model.init(
            generator_for(self.device, seed))
        self.num_slots = num_slots
        self.max_context = max_context
        self.generator = generator_for(self.device, seed + 1)
        if self._paged:
            self.kv: KVCacheManager = PagedKVCacheManager(
                num_slots, max_context, model=self.model,
                dtype=self.model.dtype, block_size=kv_block_size,
                num_blocks=kv_num_blocks)
        else:
            self.kv = KVCacheManager(num_slots, max_context,
                                     model=self.model,
                                     dtype=self.model.dtype)
        # recurrent states must never see padded prefill tokens
        self._exact_length = cfg.family in ("ssm", "hybrid")
        self.scheduler = scheduler if scheduler is not None else \
            BatchScheduler(admission=admission, token_budget=token_budget)
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.last_tokens = torch.zeros((num_slots, 1), dtype=torch.long,
                                       device=self.device)
        self.temps = torch.zeros((num_slots,), dtype=torch.float32,
                                 device=self.device)
        self.top_ks = torch.zeros((num_slots,), dtype=torch.long,
                                  device=self.device)
        self._lengths = StagedBuffer((num_slots,), torch.int32, self.device)
        # the last decode step's logits [num_slots, 1, V] (a graph's own
        # output buffer when the graph is on)
        self.last_logits: Optional[torch.Tensor] = None
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self.stats = EngineStats()
        generator = self.generator
        self._step = bind_step(self.model, self.params, self.kv,
                               self.last_tokens, self._lengths.tensor,
                               self.temps, self.top_ks, generator,
                               self._paged)
        self._graphs: Optional[DecodeGraphs] = None
        if self.decode_graph:
            stream = torch.cuda.Stream(self.device)
            pool = torch.cuda.graph_pool_handle()
            self._graphs = DecodeGraphs(
                self._step, lambda: CudaGraph(pool, stream, generator),
                self.stats, stream=stream)

    @property
    def caches(self):
        return self.kv.caches

    def submit(self, req: Request):
        self.waiting.append(req)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _finish(self, req: Request, state: RequestState, now: float) -> None:
        """The single request-termination site: stamps the terminal
        state and finish time."""
        req.state = state
        req.finish_t = now
        self.finished.append(req)

    def _ensure_caches(self) -> None:
        """Make the caches; with the graph on, warm it up first: each key's
        step runs once eagerly on caches that are then dropped for fresh
        ones (nothing is live yet), and the token buffer and the sampling
        generator are put back, so the warm-up leaves no trace."""
        if self.kv.caches is None and self._graphs is not None:
            self.kv.ensure_caches()
            rng = self.generator.get_state()
            self._graphs.warm_up(GRAPH_KEYS)
            self.generator.set_state(rng)
            self.last_tokens.zero_()
            self.kv.caches = None
        self.kv.ensure_caches()

    def _prefill_group(self, group: PrefillGroup):
        """Run one same-bucket group as one batched prefill and copy the
        rows into the per-slot caches."""
        self._ensure_caches()
        if group.bucket == 0:
            # empty/single-token prompts: nothing to prefill, the (only)
            # prompt token is fed through the shared decode step
            for slot, req in zip(group.slots, group.requests):
                self.kv.reset_slot(slot)
                self._activate(slot, req, prefilled=0)
            return
        reqs, slots = group.requests, group.slots
        toks = torch.zeros((len(reqs), group.bucket), dtype=torch.long)
        lengths = []
        token_rows = []
        for j, req in enumerate(reqs):
            feed = req.resume_tokens     # prompt (+ preempted output)
            Lp = len(feed) - 1
            toks[j, :Lp] = torch.as_tensor(feed[:Lp], dtype=torch.long)
            lengths.append(Lp)
            token_rows.append(feed[:Lp])
        t0 = time.perf_counter()
        _, prefilled = self.model.prefill(self.params, toks.to(self.device),
                                          seq_budget=self.max_context)
        # under paged KV the token ids key the prefix cache: shared full
        # blocks map to already-resident pages and skip the copy
        self.kv.merge_prefill(slots, prefilled, lengths, tokens=token_rows)
        self._sync()
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefill_calls += 1
        for slot, req, Lp in zip(slots, reqs, lengths):
            self._activate(slot, req, prefilled=Lp)

    def _activate(self, slot: int, req: Request, prefilled: int):
        if req.admit_t is None:
            req.admit_t = time.perf_counter()
        feed = req.resume_tokens
        self.last_tokens[slot, 0] = int(feed[-1]) if feed else 0
        self.temps[slot] = float(req.temperature)
        self.top_ks[slot] = int(req.top_k)
        self.stats.prefill_tokens += prefilled
        req.state = RequestState.RUNNING
        self.slots[slot] = req

    def _prefill_one(self, slot: int, req: Request):
        """Single-request prefill into ``slot`` (parity checks against the
        batched path): prefill the first L-1 prompt tokens; the last
        prompt token is fed through the shared decode step."""
        if len(req.resume_tokens) > self.max_context:
            raise ValueError(
                f"prompt of {len(req.resume_tokens)} tokens exceeds "
                f"max_context={self.max_context}")
        self.kv.take(slot)
        Lp = max(len(req.resume_tokens) - 1, 0)
        if Lp == 0:
            bucket = 0
        elif self._exact_length:
            bucket = Lp
        else:
            bucket = min(bucket_length(Lp), self.max_context)
        self._prefill_group(PrefillGroup(bucket, [slot], [req]))

    def _admit(self) -> StepPlan:
        step_plan = self.scheduler.build_step(
            self.waiting, self.kv, max_context=self.max_context,
            exact_length=self._exact_length)
        now = time.perf_counter()
        for req in step_plan.rejected:
            self._finish(req, RequestState.REJECTED, now)
        for group in step_plan.prefills:
            self._prefill_group(group)
        return step_plan

    def _decode_step(self, lengths, use_topk: bool) -> torch.Tensor:
        """Copy this step's per-slot ``lengths`` (the KV ledger's, which
        drive the attention mask and the ragged kernel's loop bound) and,
        under paged KV, a changed block table into the static buffers, then
        replay the key's graph or run the step eagerly. Returns the next
        tokens [N]; they are also in ``last_tokens``."""
        self._lengths.load(lengths)
        if self._paged:
            self.kv.table_array()      # copies the table if it changed
        key = GraphKey(use_topk=use_topk)
        run = self._graphs if self._graphs is not None else self._step
        nxt, self.last_logits = run(key)
        return nxt

    # ------------------------------------------------------------------
    # paged-KV capacity management
    # ------------------------------------------------------------------
    def _ensure_decode_capacity(self, live: List[int]) -> List[int]:
        """Grow each live slot's tail KV page before the decode write.
        On pool exhaustion, preempt the victim with the cheapest
        recompute (fewest accumulated tokens; youngest arrival breaks
        ties) — its pages are freed and the request re-queued at the HEAD
        of waiting for re-prefill from ``resume_tokens``. When no other
        slot is left to evict, the needy request ends LENGTH_CAPPED.
        Returns the slots that can decode this step."""
        ready: List[int] = []
        pending = list(live)
        while pending:
            i = pending.pop(0)
            ok = True
            while not self.kv.ensure_decode_page(i):
                candidates = [s for s in ready + pending if s != i]
                if not candidates:
                    self._finish(self.slots[i], RequestState.LENGTH_CAPPED,
                                 time.perf_counter())
                    self.slots[i] = None
                    self.kv.free(i)
                    ok = False
                    break
                victim = min(candidates,
                             key=lambda s: (self.kv.length(s),
                                            -self.slots[s].arrival_t))
                self._preempt(victim)
                if victim in ready:
                    ready.remove(victim)
                if victim in pending:
                    pending.remove(victim)
            if ok:
                ready.append(i)
        return ready

    def _preempt(self, slot: int) -> None:
        """Evict a running request to recompute: free its pages (shared
        prefix pages stay cached) and re-queue it at the head of the
        waiting line so it re-prefills — prompt AND generated tokens —
        as soon as the pool allows."""
        req = self.slots[slot]
        req.state = RequestState.WAITING
        req.preemptions += 1
        self.kv.paging.preemptions += 1
        self.slots[slot] = None
        self.kv.free(slot)
        self.last_tokens[slot, 0] = 0
        self.waiting.insert(0, req)

    def paging_stats(self) -> Optional[Dict[str, float]]:
        """Block occupancy / prefix hit-rate / preemption counters
        (None under the dense layout)."""
        return self.kv.paging_summary() if self._paged else None

    def step(self) -> bool:
        """One engine iteration; returns False when idle."""
        self._admit()
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return False
        if self._paged:
            # every live slot needs a page for this step's KV write;
            # exhaustion preempts the cheapest-to-recompute victim
            live = self._ensure_decode_capacity(live)
            if not live:
                # capacity actions (preempt/cap) happened; not idle
                return True
        use_topk = any(r is not None and r.top_k > 0 for r in self.slots)
        t0 = time.perf_counter()
        # dead slots decode as length 0
        nxt = self._decode_step(self.kv.lengths(), use_topk)
        toks = nxt.tolist()                # waits for the device
        self.stats.decode_s += time.perf_counter() - t0
        self.kv.note_decode(live)
        now = time.perf_counter()
        for i in live:
            req = self.slots[i]
            req.output.append(int(toks[i]))
            if req.first_token_t is None:
                req.first_token_t = now
            self.stats.decode_tokens += 1
            # ledger length > max_context: the cache is full; another
            # decode would clobber its last row, so the request ends here
            capped = self.kv.length(i) > self.max_context
            if req.done or capped:
                self._finish(req, RequestState.FINISHED if req.done
                             else RequestState.LENGTH_CAPPED, now)
                self.slots[i] = None
                self.kv.free(i)
        self.stats.steps += 1
        return True

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive the engine until idle (or ``max_steps``); returns the
        requests that finished during this call."""
        start = len(self.finished)
        for _ in range(max_steps):
            if not self.step() and not self.waiting:
                break
        return self.finished[start:]
