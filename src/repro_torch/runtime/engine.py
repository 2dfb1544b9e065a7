"""Continuous-batching serving engine (PyTorch counterpart of
``repro.runtime.engine`` with no plan policy): a thin loop over the
batch/KV runtime objects. Each iteration is

  1. ``BatchScheduler.build_step(waiting, kv)``: reject oversized
     prompts, admit under the admission policy, allocate KV slots, group
     admitted requests by padded prefill bucket;
  2. one batched ``model.prefill`` per ``PrefillGroup``, copied into the
     per-slot caches by the ``KVCacheManager``;
  3. one ``model.decode_step`` over the full slot batch, with per-slot
     temperature/top-k sampling; finished slots are evicted.

The engine runs eagerly on one device with ``moe_impl="capacity"`` and
dense KV. The planner (``PlanCache`` and policies), paging, expert
placement, profiling and observability are ROADMAP items of later slices
and are not accepted as arguments.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch import DeviceLike, generator_for, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.transformer import ExecutionContext
from repro_torch.runtime.batching import BatchScheduler, PrefillGroup, StepPlan
from repro_torch.runtime.kv import KVCacheManager
from repro_torch.runtime.request import Request, RequestState
from repro_torch.runtime.sampler import sample
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


class ServingEngine:
    """``device=None`` means the CUDA card and raises without one; the
    tests pass ``device="cpu"``. ``dtype`` is the compute and KV dtype
    (the weights are drawn in it when ``params`` is None)."""

    def __init__(self, cfg: ModelConfig, params=None, *, num_slots: int = 4,
                 max_context: int = 4096,
                 scheduler: Optional[BatchScheduler] = None,
                 admission: str = "fcfs",
                 token_budget: Optional[int] = None,
                 attn_impl: str = "decode_kernel",
                 dtype=torch.float32, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        ctx = ExecutionContext(attn_impl=attn_impl, moe_impl="capacity")
        self.model = build_model(cfg, ctx=ctx, dtype=dtype,
                                 device=self.device)
        self.params = params if params is not None else self.model.init(
            generator_for(self.device, seed))
        self.num_slots = num_slots
        self.max_context = max_context
        self.generator = generator_for(self.device, seed + 1)
        self.kv = KVCacheManager(num_slots, max_context, model=self.model)
        self.scheduler = scheduler if scheduler is not None else \
            BatchScheduler(admission=admission, token_budget=token_budget)
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.last_tokens = torch.zeros((num_slots, 1), dtype=torch.long,
                                       device=self.device)
        self.temps = torch.zeros((num_slots,), dtype=torch.float32,
                                 device=self.device)
        self.top_ks = torch.zeros((num_slots,), dtype=torch.long,
                                  device=self.device)
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self.stats = EngineStats()

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

    def _prefill_group(self, group: PrefillGroup):
        """Run one same-bucket group as one batched prefill and copy the
        rows into the per-slot caches."""
        self.kv.ensure_caches()
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
        for j, req in enumerate(reqs):
            feed = req.resume_tokens
            Lp = len(feed) - 1
            toks[j, :Lp] = torch.as_tensor(feed[:Lp], dtype=torch.long)
            lengths.append(Lp)
        t0 = time.perf_counter()
        _, prefilled = self.model.prefill(self.params, toks.to(self.device),
                                          seq_budget=self.max_context)
        self.kv.merge_prefill(slots, prefilled, lengths)
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
        bucket = 0 if Lp == 0 else min(bucket_length(Lp), self.max_context)
        self._prefill_group(PrefillGroup(bucket, [slot], [req]))

    def _admit(self) -> StepPlan:
        step_plan = self.scheduler.build_step(self.waiting, self.kv,
                                              max_context=self.max_context)
        now = time.perf_counter()
        for req in step_plan.rejected:
            self._finish(req, RequestState.REJECTED, now)
        for group in step_plan.prefills:
            self._prefill_group(group)
        return step_plan

    def _decode_step(self, lengths, use_topk: bool):
        logits, caches = self.model.decode_step(
            self.params, self.last_tokens, self.kv.caches, lengths=lengths)
        nxt = sample(self.generator, logits[:, -1], self.temps,
                     self.top_ks if use_topk else 0)
        return nxt[:, None], caches

    def step(self) -> bool:
        """One engine iteration; returns False when idle."""
        self._admit()
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return False
        use_topk = any(r is not None and r.top_k > 0 for r in self.slots)
        # the ledger's per-slot context lengths drive the attention mask
        # AND the ragged kernel's loop bound (dead slots decode as len 0)
        lengths = torch.as_tensor(self.kv.lengths(), dtype=torch.int32,
                                  device=self.device)
        t0 = time.perf_counter()
        nxt, new_caches = self._decode_step(lengths, use_topk)
        toks = nxt[:, 0].tolist()          # waits for the device
        self.stats.decode_s += time.perf_counter() - t0
        self.kv.caches = new_caches
        self.last_tokens = nxt
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
