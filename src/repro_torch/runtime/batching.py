"""Iteration-level batch scheduling (Orca-style): admission policies +
``StepPlan`` construction (a copy of ``repro.runtime.batching`` without the
paged-KV branches, which come with ``runtime/paging.py``).

Every engine iteration asks the ``BatchScheduler`` what to run:

    build_step(waiting, kv) -> StepPlan

The scheduler rejects oversized prompts, admits waiting requests under the
configured admission policy (bounded by free KV slots and an optional
per-step prefill token budget), allocates their slots from the
``KVCacheManager``, and groups admitted requests by padded prefill bucket
so several requests run as ONE batched ``model.prefill`` call.

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
    ``waiting``; returns a subset, at most ``free_slots`` long)."""

    name: str

    def admit(self, waiting: Sequence[Request], free_slots: int,
              token_budget: Optional[int] = None) -> List[Request]:
        ...


def _prefill_cost(req: Request) -> int:
    return max(len(req.resume_tokens) - 1, 0)


class FCFSAdmission:
    name = "fcfs"

    def admit(self, waiting, free_slots, token_budget=None):
        return list(waiting[:max(free_slots, 0)])


class ShortestPromptFirst:
    name = "spf"

    def admit(self, waiting, free_slots, token_budget=None):
        ranked = sorted(waiting, key=lambda r: (_prefill_cost(r),
                                                r.arrival_t, r.request_id))
        return ranked[:max(free_slots, 0)]


class TokenBudgetAdmission:
    """FCFS order under a per-step prefill token budget."""

    name = "token_budget"

    def __init__(self, token_budget: int = 512):
        self.token_budget = token_budget

    def admit(self, waiting, free_slots, token_budget=None):
        budget = self.token_budget if token_budget is None else token_budget
        out: List[Request] = []
        total = 0
        for req in waiting:
            if len(out) >= free_slots:
                break
            cost = _prefill_cost(req)
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
                   max_context: Optional[int] = None) -> StepPlan:
        """Admit from (and pop out of) ``waiting``, allocate slots, group
        by bucket."""
        max_context = max_context or kv.max_context
        plan = StepPlan()
        keep = []
        for req in waiting:
            # the full sequence — the last token is fed through decode —
            # must fit the per-slot cache
            n_total = len(req.resume_tokens)
            if n_total > max_context:
                req.error = (f"prompt of {n_total} tokens exceeds "
                             f"max_context={max_context}; refusing to "
                             "truncate")
                plan.rejected.append(req)
            else:
                keep.append(req)
        waiting[:] = keep

        admitted = self.admission.admit(waiting, kv.free_count(),
                                        self.token_budget)
        if self.token_budget is not None:
            # the budget bounds every step regardless of admission policy;
            # the first request always passes so it cannot starve
            capped: List[Request] = []
            total = 0
            for req in admitted:
                cost = _prefill_cost(req)
                if capped and total + cost > self.token_budget:
                    break
                capped.append(req)
                total += cost
            admitted = capped
        groups: Dict[int, PrefillGroup] = {}
        for req in admitted:
            slot = kv.alloc()
            if slot is None:     # defensive: admission overshot capacity
                break
            waiting.remove(req)
            cost = _prefill_cost(req)
            bucket = 0 if cost == 0 else min(bucket_length(cost), max_context)
            group = groups.setdefault(bucket, PrefillGroup(bucket))
            group.slots.append(slot)
            group.requests.append(req)
        plan.prefills = [groups[b] for b in sorted(groups)]
        plan.decode_slots = kv.live_slots()
        return plan
