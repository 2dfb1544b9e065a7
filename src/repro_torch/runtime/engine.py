"""Continuous-batching serving engine (PyTorch counterpart of
``repro.runtime.engine``): a thin loop over the batch/KV runtime objects.
Each iteration is

  1. ``BatchScheduler.build_step(waiting, kv)``: reject oversized
     prompts, admit under the admission policy, allocate KV slots, group
     admitted requests by padded prefill bucket;
  2. batched ``model.prefill`` calls per ``PrefillGroup`` (chunked by the
     resolved plan's r1·m_a granularity), copied into the per-slot caches
     by the ``KVCacheManager``;
  3. under ``kv_layout="paged"``, a tail page for every live slot's next
     KV write, preempting the cheapest-to-recompute slot when the pool is
     exhausted;
  4. one decode step over the full slot batch (``runtime/decode_graph``:
     ``Model.decode_step``, per-slot temperature/top-k sampling), fed from
     static buffers; finished slots are evicted.

On a CUDA device the decode step is a CUDA graph, captured once per
static key and replayed at every step: the counterpart of the reference's
jitted decode. ``decode_graph=False`` runs the same step function eagerly
(the CPU always does). KV is dense or paged (``runtime/paging.py``);
recurrent (ssm and hybrid) models keep per-slot states and prefill by
exact prompt length.

Scheduling goes through a pluggable ``repro_torch.sched.SchedulePolicy``
behind a ``PlanCache`` (``plan_policy=``), the paper's online phase: every
prefill group resolves a plan for its (bucket, batch) shape and every
decode step one for the KV ledger's ``OccupancySummary``. The plans are
always resolved (``resolved_plans()``), but reach the model only when
the DEP executor runs: ``ep_group=`` (a ``core.dep.DepGroups`` of one
rank) turns the MoE layers into the DEP walk of each plan's
``ExecProgram``, which also keys the decode graph; without it the MoE
layers run the capacity path. An expert group of several ranks (sharded
weights, one process per card) is not served yet and raises.
Expert placement, the measured cost profile and observability are not
ported yet; their arguments raise (``_NOT_PORTED``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import DeviceLike, generator_for, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dep import as_exec_program
from repro_torch.core.solver import Plan
from repro_torch.core.taskgraph import ATTN, LoweringSpec, lower
from repro_torch.models import build_model
from repro_torch.models.transformer import ExecutionContext
from repro_torch.runtime.batching import BatchScheduler, PrefillGroup, StepPlan
from repro_torch.runtime.decode_graph import (CudaGraph, DecodeGraphs,
                                              GraphKey, StagedBuffer,
                                              bind_step)
from repro_torch.runtime.kv import KVCacheManager
from repro_torch.runtime.paging import PagedKVCacheManager
from repro_torch.runtime.request import Request, RequestState
from repro_torch.sched import PlanCache, SchedulePolicy
from repro_torch.sched.occupancy import bucket_length

#: arguments of the reference's engine that the port does not take yet,
#: with the ROADMAP Queue 1 item that brings each
_NOT_PORTED = {
    "profile": 5, "calibrate": 5, "profile_store": 5, "telemetry": 5,
    "drift_threshold": 5, "drift_min_samples": 5, "drift_recalibrate": 5,
    "recalibrate_max_age_s": 5,
    "tracer": 6, "metrics": 6,
    "replicate_hot_k": 7, "rebalance_threshold": 7, "track_expert_load": 7,
    "rebalance_min_observations": 7, "max_capacity_scale": 7,
}


def prefill_split(plan: Optional[Plan], n: int) -> Tuple[int, int]:
    """(requests per prefill call, micro-batch streams of each call's DEP
    program) for a group of ``n`` under ``plan``: the lowered graph's
    micro-batches one plan iteration admits, times the samples per
    micro-batch. No plan: one call of one stream."""
    if plan is None:
        return n, 1
    n_mb = len(lower(plan, LoweringSpec(T=1)).tasks_of(ATTN, layer=0))
    return max(min(n_mb * max(int(plan.m_a), 1), n), 1), n_mb


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
    # the DEP program of every model call, in order: ("prefill" or
    # "decode", ExecProgram); empty while DEP is off
    programs: List[Tuple[str, object]] = field(default_factory=list)


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
    on the CPU raises, False runs the step eagerly.

    ``plan_policy`` is any ``SchedulePolicy`` (a ``PlanCache`` of
    ``plan_cache_capacity`` entries memoizes it); ``ep_group`` the
    ``DepGroups`` of the DEP executor, None for no DEP (the reference's
    ``mesh=None``). The group must be of one rank (``expert_size`` 1):
    the engine holds every expert's weights, so a wider group raises. ``interleave`` is the DEP walk's emission, "streams"
    (scheduled start order) or "off" (stream after stream): the same
    values either way. ``validate`` runs ``analysis.graphcheck`` on every
    distinct program before it is used."""

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
                 decode_graph: Optional[bool] = None,
                 plan_policy: Optional[SchedulePolicy] = None,
                 plan_cache_capacity: Optional[int] = None,
                 ep_group=None,
                 interleave: str = "streams",
                 validate: bool = False,
                 **not_ported):
        for name in not_ported:
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected argument {name!r}")
            raise NotImplementedError(
                f"{name}= is not ported yet (ROADMAP Queue 1 item "
                f"{_NOT_PORTED[name]})")
        if interleave not in ("off", "streams"):
            raise ValueError(f"interleave must be 'off' or 'streams', "
                             f"got {interleave!r}")
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
        if ep_group is not None and ep_group.expert_size > 1:
            raise NotImplementedError(
                f"an expert group of {ep_group.expert_size} ranks: the "
                "engine serves DEP at an expert group of one rank only "
                "(sharded serving is ROADMAP Queue 1 item 11)")
        self.plan_policy = plan_policy
        self.plan_cache = (PlanCache(plan_policy,
                                     capacity=plan_cache_capacity)
                           if (plan_policy is not None and cfg.is_moe)
                           else None)
        # plans reach the model only when the DEP executor can act on them
        self._dep_active = ep_group is not None and cfg.is_moe
        self.interleave = interleave
        self.validate = bool(validate)
        self._validated_programs: set = set()
        ctx = ExecutionContext(
            attn_impl=attn_impl,
            moe_impl="dep" if self._dep_active else "capacity",
            groups=ep_group if self._dep_active else None)
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
        """Make the caches; with the graph on, warm it up first: the step
        of every key named up front (both sampling variants; under DEP on
        the unchunked program) runs once eagerly on caches that are then
        dropped for fresh ones (nothing is live yet), and the token buffer
        and the sampling generator are put back, so the warm-up leaves no
        trace. Keys met later are captured without an eager run."""
        if self.kv.caches is None and self._graphs is not None:
            self.kv.ensure_caches()
            rng = self.generator.get_state()
            program = as_exec_program(None) if self._dep_active else None
            self._graphs.warm_up([GraphKey(use_topk, program)
                                  for use_topk in (False, True)])
            self.generator.set_state(rng)
            self.last_tokens.zero_()
            self.kv.caches = None
        self.kv.ensure_caches()

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _resolve_plan(self, phase: str, seq_bucket: Optional[int] = None,
                      batch_per_device: Optional[int] = None,
                      occupancy=None) -> Optional[Plan]:
        if self.plan_cache is None:
            return None
        return self.plan_cache.get(phase, seq_bucket, batch_per_device,
                                   occupancy=occupancy)

    def _exec_program(self, plan: Optional[Plan],
                      streams: Optional[int] = None):
        """The ``ExecProgram`` the DEP executor walks for ``plan``
        (hashable, so plans that lower to the same program share one
        decode graph). ``streams`` overrides the stream split: a prefill
        call covers the lowered chunk's micro-batches; decode uses the
        plan's r1. None when DEP is off (after validation, if on)."""
        if plan is None or (not self._dep_active and not self.validate):
            return None
        program = plan.exec_program(streams=streams,
                                    interleave=self.interleave)
        if self.validate:
            self._check_program(program)
        return program if self._dep_active else None

    def _check_program(self, program) -> None:
        """Static-verify an ExecProgram (see ``validate``), once per
        distinct program."""
        if program in self._validated_programs:
            return
        from repro_torch.analysis import AnalysisError
        from repro_torch.analysis.graphcheck import check_exec_program
        violations = check_exec_program(program)
        if violations:
            raise AnalysisError(violations)
        self._validated_programs.add(program)

    def resolved_plans(self) -> Dict[Any, Plan]:
        """Every resolution so far: prefill plans keyed (phase, bucket,
        batch), decode plans keyed (phase, OccupancySummary)."""
        return self.plan_cache.entries() if self.plan_cache else {}

    def _prefill_group(self, group: PrefillGroup):
        """Run one same-bucket group as batched prefill calls, chunked by
        the resolved plan's r1·m_a granularity (the samples one plan
        iteration admits), and copy the rows into the per-slot caches."""
        self._ensure_caches()
        if group.bucket == 0:
            # empty/single-token prompts: nothing to prefill, the (only)
            # prompt token is fed through the shared decode step
            for slot, req in zip(group.slots, group.requests):
                self.kv.reset_slot(slot)
                self._activate(slot, req, prefilled=0)
            return
        plan = self._resolve_plan("prefill", group.bucket,
                                  len(group.requests))
        chunk, n_mb = prefill_split(plan, len(group.requests))
        program = self._exec_program(plan, streams=n_mb)
        for ofs in range(0, len(group.requests), chunk):
            reqs = group.requests[ofs:ofs + chunk]
            slots = group.slots[ofs:ofs + chunk]
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
            _, prefilled = self.model.prefill(
                self.params, toks.to(self.device),
                seq_budget=self.max_context, plan=program)
            # under paged KV the token ids key the prefix cache: shared
            # full blocks map to already-resident pages and skip the copy
            self.kv.merge_prefill(slots, prefilled, lengths,
                                  tokens=token_rows)
            self._sync()
            self.stats.prefill_s += time.perf_counter() - t0
            self.stats.prefill_calls += 1
            if program is not None:
                self.stats.programs.append(("prefill", program))
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

    def _decode_step(self, lengths, use_topk: bool,
                     program=None) -> torch.Tensor:
        """Copy this step's per-slot ``lengths`` (the KV ledger's, which
        drive the attention mask and the ragged kernel's loop bound) and,
        under paged KV, a changed block table into the static buffers, then
        replay the key's graph or run the step eagerly. ``program`` is the
        step's DEP program. Returns the next tokens [N]; they are also in
        ``last_tokens``."""
        self._lengths.load(lengths)
        if self._paged:
            self.kv.table_array()      # copies the table if it changed
        key = GraphKey(use_topk=use_topk, plan=program)
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
        # the decode plan is solved on the ledger's live composition and
        # re-resolved only when it changes
        program = self._exec_program(self._resolve_plan(
            "decode", occupancy=self.kv.occupancy()))
        if program is not None:
            self.stats.programs.append(("decode", program))
        use_topk = any(r is not None and r.top_k > 0 for r in self.slots)
        t0 = time.perf_counter()
        # dead slots decode as length 0
        nxt = self._decode_step(self.kv.lengths(), use_topk, program)
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
