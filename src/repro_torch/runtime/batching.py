"""Iteration-level batch scheduling (Orca-style): admission policies +
``StepPlan`` construction (a copy of ``repro.runtime.batching``).

Every engine iteration asks the ``BatchScheduler`` what to run:

    build_step(waiting, kv) -> StepPlan

The scheduler rejects oversized prompts, admits waiting requests under the
configured admission policy (bounded by free KV slots and an optional
per-step prefill token budget), allocates their slots from the
``KVCacheManager``, and groups admitted requests by padded prefill bucket
so several requests run as ONE batched ``model.prefill`` call. Under a
``PagedKVCacheManager`` admission also answers to the page pool.

Admission policies:
  fcfs          arrival order, fill every free slot
  spf           shortest-prompt-first (minimizes mean TTFT under load)
  token_budget  FCFS order, but stop admitting once the step's prefill
                tokens would exceed the budget (the first admitted request
                is always let through so a long prompt cannot starve)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, runtime_checkable

from repro_torch.runtime.kv import KVCacheManager
from repro_torch.runtime.request import Request
from repro_torch.sched.occupancy import bucket_length


@dataclass
class PrefillGroup:
    """Same-bucket requests prefilled in one padded batch. ``bucket`` is
    the padded prompt length (0 => nothing to prefill: empty or
    single-token prompts that go straight to decode)."""

    bucket: int
    slots: List[int] = field(default_factory=list)
    requests: List[Request] = field(default_factory=list)

    @property
    def prefill_tokens(self) -> int:
        return sum(max(len(r.prompt) - 1, 0) for r in self.requests)


@dataclass
class StepPlan:
    """What one engine iteration executes."""

    prefills: List[PrefillGroup] = field(default_factory=list)
    decode_slots: List[int] = field(default_factory=list)
    rejected: List[Request] = field(default_factory=list)

    @property
    def num_prefilled(self) -> int:
        return sum(len(g.requests) for g in self.prefills)

    @property
    def prefill_tokens(self) -> int:
        return sum(g.prefill_tokens for g in self.prefills)


@runtime_checkable
class AdmissionPolicy(Protocol):
    """Pick which waiting requests to admit this step (does not mutate
    ``waiting``; returns a subset, at most ``free_slots`` long).
    ``cost_fn`` overrides the per-request prefill cost — the paged-KV
    scheduler passes a prefix-discounted cost so cached prompts don't
    burn token budget they won't stream. Policies may ignore it; the
    scheduler falls back to the 3-arg call for older implementations."""

    name: str

    def admit(self, waiting: Sequence[Request], free_slots: int,
              token_budget: Optional[int] = None,
              cost_fn=None) -> List[Request]:
        ...


def _prefill_cost(req: Request) -> int:
    # resume_tokens == prompt for fresh requests; after a paged-KV
    # preemption it includes the generated tokens whose KV must be rebuilt
    return max(len(req.resume_tokens) - 1, 0)


class FCFSAdmission:
    name = "fcfs"

    def admit(self, waiting, free_slots, token_budget=None, cost_fn=None):
        return list(waiting[:max(free_slots, 0)])


class ShortestPromptFirst:
    name = "spf"

    def admit(self, waiting, free_slots, token_budget=None, cost_fn=None):
        cost = cost_fn or _prefill_cost
        ranked = sorted(waiting, key=lambda r: (cost(r),
                                                r.arrival_t, r.request_id))
        return ranked[:max(free_slots, 0)]


class TokenBudgetAdmission:
    """FCFS order under a per-step prefill token budget."""

    name = "token_budget"

    def __init__(self, token_budget: int = 512):
        self.token_budget = token_budget

    def admit(self, waiting, free_slots, token_budget=None, cost_fn=None):
        budget = self.token_budget if token_budget is None else token_budget
        cost_of = cost_fn or _prefill_cost
        out: List[Request] = []
        total = 0
        for req in waiting:
            if len(out) >= free_slots:
                break
            cost = cost_of(req)
            if out and total + cost > budget:
                break
            out.append(req)
            total += cost
        return out


ADMISSIONS = ("fcfs", "spf", "token_budget")


def make_admission(name: str, *,
                   token_budget: Optional[int] = None) -> AdmissionPolicy:
    if name == "fcfs":
        return FCFSAdmission()
    if name == "spf":
        return ShortestPromptFirst()
    if name == "token_budget":
        return TokenBudgetAdmission(token_budget or 512)
    raise ValueError(f"unknown admission policy {name!r}; "
                     f"choose from {ADMISSIONS}")


class BatchScheduler:
    """Builds one ``StepPlan`` per engine iteration.

    ``admission`` is a name from ``ADMISSIONS`` or any
    ``AdmissionPolicy``. ``token_budget`` (when set) bounds the prefill
    tokens any single step admits, independent of the policy.
    """

    def __init__(self, admission="fcfs",
                 token_budget: Optional[int] = None):
        if isinstance(admission, str):
            admission = make_admission(admission, token_budget=token_budget)
        self.admission = admission
        self.token_budget = token_budget

    def build_step(self, waiting: List[Request], kv: KVCacheManager, *,
                   max_context: Optional[int] = None,
                   exact_length: bool = False) -> StepPlan:
        """Admit from (and pop out of) ``waiting``, allocate slots, group
        by bucket. ``exact_length`` disables bucket padding (recurrent
        states would be corrupted by padded prefill tokens, so SSM/hybrid
        prompts group by exact length)."""
        max_context = max_context or kv.max_context
        plan = StepPlan()
        # block-granular KV (PagedKVCacheManager): admission also answers
        # to the page pool — watermark hysteresis, a per-request new-page
        # charge discounted by the prefix cache, and a pool-capacity cap
        paged = hasattr(kv, "admission_charge")

        keep = []
        for req in waiting:
            # the full (resume) sequence — the last token is fed through
            # decode — must fit the per-slot cache, else decode writes
            # clamp/overwrite
            n_total = len(req.resume_tokens)
            if n_total > max_context:
                req.error = (f"prompt of {n_total} tokens exceeds "
                             f"max_context={max_context}; refusing to "
                             "truncate")
                plan.rejected.append(req)
            elif paged and (kv.blocks_for_tokens(max(n_total - 1, 0))
                            > kv.pool.usable - 1):
                req.error = (f"prompt needs more KV pages than the pool "
                             f"holds ({kv.pool.usable} usable blocks of "
                             f"{kv.block_size})")
                plan.rejected.append(req)
            else:
                keep.append(req)
        waiting[:] = keep

        if paged and kv.admission_blocked():
            # above the high watermark: run decode-only steps until the
            # pool drains below the low watermark
            plan.decode_slots = kv.live_slots()
            return plan

        cost_fn = _prefill_cost
        if paged:
            def cost_fn(req):
                toks = req.resume_tokens
                Lp = max(len(toks) - 1, 0)
                return max(Lp - kv.cached_prefix_tokens(toks[:Lp]), 0)

        try:
            admitted = self.admission.admit(waiting, kv.free_count(),
                                            self.token_budget,
                                            cost_fn=cost_fn)
        except TypeError:   # older 3-arg AdmissionPolicy implementations
            admitted = self.admission.admit(waiting, kv.free_count(),
                                            self.token_budget)
        if self.token_budget is not None:
            # the budget bounds every step regardless of admission policy
            # (TokenBudgetAdmission additionally uses it to pick WHICH
            # requests to admit); the first request always passes so a
            # prompt larger than the budget cannot starve
            capped: List[Request] = []
            total = 0
            for req in admitted:
                cost = cost_fn(req)
                if capped and total + cost > self.token_budget:
                    break
                capped.append(req)
                total += cost
            admitted = capped
        if paged:
            # charge each admit its NEW pages (prefix hits are free) and
            # stop before the pool runs out, keeping one page of decode
            # headroom per already-live slot to delay preemption
            avail = kv.blocks_free() - kv.live_count()
            fitting: List[Request] = []
            for req in admitted:
                toks = req.resume_tokens
                new_pages, _ = kv.admission_charge(
                    toks[:max(len(toks) - 1, 0)])
                if new_pages > avail:
                    break
                fitting.append(req)
                avail -= new_pages
            admitted = fitting
        groups: Dict[int, PrefillGroup] = {}
        for req in admitted:
            slot = kv.alloc()
            if slot is None:     # defensive: admission overshot capacity
                break
            waiting.remove(req)
            cost = _prefill_cost(req)
            if cost == 0:
                bucket = 0
            elif exact_length:
                bucket = cost
            else:
                bucket = min(bucket_length(cost), max_context)
            group = groups.setdefault(bucket, PrefillGroup(bucket))
            group.slots.append(slot)
            group.requests.append(req)
        plan.prefills = [groups[b] for b in sorted(groups)]
        plan.decode_slots = kv.live_slots()
        return plan
