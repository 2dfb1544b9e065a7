"""A copy of ``repro.profiling.refresh``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other. ``PeriodicRecalibrator`` takes the port's ``groups``
(a ``core.dep.DepGroups``), ``device`` and ``dtype`` where the
original takes a mesh, and by default runs the port's ``calibrate``
and ``ProfileKey.for_host`` on them.

Drift-triggered plan refresh: invalidate + re-solve off the critical
path.

The closing arc of the measure->fit->plan->observe loop (and the ROADMAP
follow-up "cost-aware cache eviction + background re-solve so a solver
hiccup can never stall a decode step"):

  * ``StepTimer`` (telemetry) accumulates per-plan-key EWMA residuals;
  * ``DriftMonitor.observe`` compares each key's residual against a
    threshold; a breach optionally rescales the planner's hardware
    profile onto the measured wall-times (uniform rescale — argmax
    preserved, predictions corrected) and hands the key to the
    ``PlanRefresher``;
  * ``PlanRefresher`` runs ``PlanCache.refresh(key)`` on a worker thread:
    the STALE PLAN KEEPS SERVING — the cache entry is only replaced when
    the new solve lands, so no decode step ever waits on Algorithm 1.

Two refinements ride on the task-graph IR and the profile store:

  * per-primitive drift retuning: observations tagged with the lowered
    graph's gemm/attn/comm breakdown let a recalibrating episode fit
    per-primitive scale factors (``profiling.attribution``) and rescale
    alpha_c/beta_c (comm) separately from the compute terms;
    the uniform whole-profile rescale remains the fallback whenever the
    tags are missing or cannot identify the scales;
  * ``PeriodicRecalibrator``: cron-style background re-calibration — when
    the stored profile for this host goes stale
    (``StoredProfile.is_stale``), re-run ``microbench.calibrate()`` on
    the worker pool and refresh every cached plan, instead of waiting
    for drift to trip. On a group of several ranks the port splits the
    job: the local sweeps on the worker, the comm samples one a step on
    the main thread, in lock step (``CalibStep``).

Thread-safety: the refresh worker only touches ``PlanCache`` /
``FinDEPPlanner`` dicts (GIL-atomic ops); a concurrent engine-thread miss
can at worst duplicate one solve, never corrupt state.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from functools import partial
from typing import (Callable, Dict, Hashable, List, Mapping, NamedTuple,
                    Optional)

import torch

from repro_torch.profiling.attribution import (attribution_rows,
                                               fit_primitive_scales)
from repro_torch.profiling import microbench as mb
from repro_torch.profiling.telemetry import StepTimer


def planner_of(policy):
    """The FinDEPPlanner behind a planner-backed policy (None for
    planner-free policies such as StaticPolicy)."""
    return getattr(policy, "planner", None)


def rescale_policy_hardware(policy, ratio: float,
                            clamp: float = 10.0) -> bool:
    """Uniformly rescale the policy's hardware profile by ``ratio``
    (measured/predicted) and drop the planner memo, so subsequent solves
    predict the observed wall-times. Returns False when the policy has no
    planner to retune."""
    planner = planner_of(policy)
    if planner is None or not hasattr(planner, "set_hardware"):
        return False
    ratio = min(max(ratio, 1.0 / clamp), clamp)
    planner.set_hardware(planner.hardware.scaled(ratio))
    return True


def rescale_policy_hardware_by(policy, scales: Mapping[str, float]) -> bool:
    """Per-primitive rescale (``HardwareProfile.scaled_by``): retune each
    alpha-beta model by its own measured/predicted ratio. Unlike the
    uniform rescale this can move the solver's argmax — that is the
    point of task-tagged attribution."""
    planner = planner_of(policy)
    if planner is None or not hasattr(planner, "set_hardware"):
        return False
    planner.set_hardware(planner.hardware.scaled_by(dict(scales)))
    return True


class PlanRefresher:
    """Background executor for ``PlanCache.refresh``; one in-flight
    refresh per key (duplicate requests while a solve is running are
    dropped, not queued)."""

    def __init__(self, cache, max_workers: int = 1,
                 on_done: Optional[Callable[[Hashable], None]] = None,
                 metrics=None):
        self.cache = cache
        self.on_done = on_done
        self._max_workers = max_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._inflight: Dict[Hashable, Future] = {}
        self.requested = 0
        self.completed = 0
        self.failed = 0
        # optional obs.MetricsRegistry: completion/failure become counted
        # events instead of attributes a reader must poll
        self._m_completed = self._m_failed = None
        if metrics is not None:
            self._m_completed = metrics.counter(
                "repro_plan_refresh_completed_total",
                "background plan re-solves that landed")
            self._m_failed = metrics.counter(
                "repro_plan_refresh_failed_total",
                "background plan re-solves that raised or were cancelled")

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._max_workers,
                thread_name_prefix="plan-refresh")
        return self._pool

    def request(self, key: Hashable) -> bool:
        """Schedule a background re-solve of ``key``; returns False when
        one is already in flight. Never blocks on the solve."""
        return self.request_job(key, lambda: self.cache.refresh(key))

    def request_job(self, key: Hashable, fn: Callable[[], object]) -> bool:
        """Schedule an arbitrary background job under ``key`` with the
        same one-in-flight-per-key dedup as ``request`` (used by
        ``PeriodicRecalibrator`` to run microbenchmarks off the critical
        path). Returns False when ``key`` is already in flight."""
        with self._lock:
            if key in self._inflight:
                return False
            fut = self._ensure_pool().submit(fn)
            self._inflight[key] = fut
            self.requested += 1
        fut.add_done_callback(lambda f, k=key: self._finish(k, f))
        return True

    def _finish(self, key: Hashable, fut: Future) -> None:
        with self._lock:
            self._inflight.pop(key, None)
            if fut.cancelled() or fut.exception() is not None:
                self.failed += 1
                counter = self._m_failed
            else:
                self.completed += 1
                counter = self._m_completed
        if counter is not None:
            counter.inc()
        if self.on_done is not None:
            self.on_done(key)

    def in_flight(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._inflight

    def pending(self) -> int:
        with self._lock:
            return len(self._inflight)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Wait for every in-flight refresh (tests / shutdown)."""
        while True:
            with self._lock:
                futs = list(self._inflight.values())
            if not futs:
                return
            for f in futs:
                f.exception(timeout=timeout)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


@dataclass
class DriftStats:
    observations: int = 0
    drift_events: int = 0
    last_drift_key: Optional[Hashable] = None
    last_drift_residual: Optional[float] = None
    per_key_events: Dict[Hashable, int] = field(default_factory=dict)
    #: per-primitive scales applied by the last recalibrating episode
    #: (None = the uniform whole-profile rescale was used)
    last_scales: Optional[Dict[str, float]] = None


class DriftMonitor:
    """Watches per-key residuals and triggers at most one background
    re-solve per drift episode.

    ``threshold`` is on |EWMA residual| (0.5 = the measured step ran 50%
    off the model); ``min_samples`` observations must accrue before a key
    can trigger. After triggering, the key is quiet until its refresh
    lands (in-flight dedup) AND its residual history restarts from zero
    samples (``timer.reset_key`` on completion), so one drift episode
    costs exactly one solve.

    ``recalibrate=True`` additionally rescales the policy's hardware
    profile onto the measured wall-times before re-solving, so the
    refreshed plans' predictions match reality and the episode converges
    instead of re-triggering forever. Since a rescale invalidates every
    cached plan's modeled makespan, a recalibrating episode refreshes ALL
    cache entries (one worker pass) and restarts every key's residual
    history.

    ``per_primitive=True`` (default) makes a recalibrating episode try
    task-tagged attribution first: when the accumulated observations
    carry per-primitive breakdowns (plans lowered through the task-graph
    IR tag their predictions with gemm/attn/comm splits) and the key
    compositions identify the scales, each alpha-beta model is retuned
    by its OWN measured/predicted ratio (``scaled_by``) instead of the
    uniform whole-profile rescale; the uniform rescale stays as the
    fallback when tags are missing or unidentifiable.
    """

    def __init__(self, cache, *, timer: Optional[StepTimer] = None,
                 refresher: Optional[PlanRefresher] = None,
                 threshold: float = 0.5, min_samples: int = 3,
                 recalibrate: bool = True, per_primitive: bool = True,
                 metrics=None):
        assert threshold > 0.0
        self.cache = cache
        self.timer = timer if timer is not None else StepTimer()
        self.refresher = (refresher if refresher is not None
                          else PlanRefresher(cache, metrics=metrics))
        if self.refresher.on_done is None:
            self.refresher.on_done = self._on_refresh_done
        self.threshold = threshold
        self.min_samples = min_samples
        self.recalibrate = recalibrate
        self.per_primitive = per_primitive
        self.stats = DriftStats()
        self._m_drift = None
        if metrics is not None:
            self._m_drift = metrics.counter(
                "repro_drift_events_total",
                "per-key residual EWMA breaches that scheduled a refresh")

    def _on_refresh_done(self, key: Hashable) -> None:
        # the replaced plan's residuals describe the OLD model; start the
        # new episode from a clean slate
        self.timer.reset_key(key)

    def _rescale(self, ewma: float) -> Optional[Dict[str, float]]:
        """Retune the policy's hardware profile onto the measured
        wall-times: per-primitive when task-tagged breakdowns identify
        the scales, uniform otherwise. Returns the applied per-primitive
        scales (None = uniform fallback)."""
        if self.per_primitive:
            scales = fit_primitive_scales(attribution_rows(self.timer.keys))
            if scales is not None and rescale_policy_hardware_by(
                    self.cache.policy, scales):
                return scales
        rescale_policy_hardware(self.cache.policy, 1.0 + ewma)
        return None

    def observe(self, key: Hashable, measured_s: float,
                predicted_s: Optional[float], phase: str = "decode",
                breakdown: Optional[Mapping[str, float]] = None) -> bool:
        """Record one measured step against its prediction (``breakdown``
        = the plan's modeled per-primitive split, for attribution);
        returns True when this observation tripped the drift threshold
        and a background refresh was scheduled."""
        self.stats.observations += 1
        self.timer.observe(phase, measured_s, predicted_s=predicted_s,
                           key=key, breakdown=breakdown)
        st = self.timer.keys.get(key)
        if st is None or st.count < self.min_samples:
            return False
        ewma = st.residual_ewma
        if ewma is None or abs(ewma) < self.threshold:
            return False
        if self.refresher.in_flight(key):
            return False              # already refreshing this key
        if self.recalibrate:
            # a recalibrating episode must not START while any refresh
            # (or background calibration sharing this pool) is still in
            # flight: the stale entries keep serving their OLD predicted
            # makespans until their re-solve lands, so a key could
            # re-breach on the same hardware shift and COMPOUND the
            # rescale (2x -> 4x -> ...) before the first correction ever
            # reaches a prediction
            if self.refresher.pending() > 0:
                return False
            # the rescale invalidates EVERY cached plan's prediction (all
            # were solved under the old fit), not just this key's: refresh
            # them all and restart every residual history — otherwise each
            # remaining stale key would re-breach on the same hardware
            # shift and compound the correction
            self.stats.last_scales = self._rescale(ewma)
            for k in self.timer.keys:
                self.timer.reset_key(k)
            if not any([self.refresher.request(k)
                        for k in self.cache.entries()]):
                return False
        elif not self.refresher.request(key):
            return False
        self.stats.drift_events += 1
        self.stats.last_drift_key = key
        self.stats.last_drift_residual = ewma
        self.stats.per_key_events[key] = \
            self.stats.per_key_events.get(key, 0) + 1
        if self._m_drift is not None:
            self._m_drift.inc()
        return True

    def close(self) -> None:
        self.refresher.close()


NO_SAMPLE = -1
JOB_DONE = -2


class CalibStep(NamedTuple):
    """The calibration field of a decode call's lock-step header: what
    every rank of a group does at this step's end, as rank 0 decided.
    ``start`` 1: begin a job's local sweeps on the refresh worker;
    ``sample`` >= 0: run that comm sample (``size`` bytes a rank) on the
    main thread; ``JOB_DONE``: the job's samples are all taken, fit it;
    ``NO_SAMPLE``: nothing."""

    start: int = 0
    sample: int = NO_SAMPLE
    size: int = 0

#: the field of a step that runs nothing of a calibration
IDLE = CalibStep()


@dataclass
class _GroupJob:
    """One re-calibration on a group of several ranks, as one rank holds
    it: ``sizes`` is one comm sweep (empty when ``calibrate_fn`` gives
    the whole result), ``plan`` the sizes rank 0 issues (a sweep, again
    per retry), ``sweeps`` the comm samples this rank took, one
    ``MicrobenchSamples`` per sweep. ``local`` is the worker's result,
    set before ``ready``."""

    number: int
    sizes: tuple
    plan: list
    sweeps: list = field(default_factory=list)
    issued: int = 0
    sample_s: float = 0.0
    local: object = None
    error: Optional[BaseException] = None
    ready: threading.Event = field(default_factory=threading.Event)


class PeriodicRecalibrator:
    """Cron-style background re-calibration: when the stored profile for
    this host goes stale (``StoredProfile.is_stale(max_age_s)``), re-run
    the microbenchmarks on the refresh worker pool, persist the new fit,
    reprofile the policy, and refresh every cached plan — instead of
    waiting for drift to trip. Complements ``DriftMonitor``: drift reacts
    to observed residuals, this one to calendar age.

    ``maybe_recalibrate()`` is cheap enough to call once per engine step:
    store reads are throttled to ``poll_interval_s`` and the calibration
    itself runs as a deduplicated background job (one in flight at a
    time; the serving loop never waits on a microbenchmark).

    CAVEAT: the microbenchmarks time the SAME device the engine serves
    on, so a sweep that overlaps live traffic measures contended
    primitives and fits a pessimistic profile. Prefer a ``max_age_s``
    long enough that re-calibration lands in natural idle gaps, or call
    ``maybe_recalibrate(force=True)`` from a maintenance window. Sharing
    the ``DriftMonitor``'s refresher (the engine wiring does) at least
    keeps drift episodes from firing off the contended wall-times while
    the calibration job is in flight.

    ``calibrate_fn`` defaults to ``microbench.calibrate(fast=True)`` on
    ``device`` under ``groups`` at ``dtype`` (f32 by default); tests
    inject a stub.

    On a group of several ranks (``lockstep``, the engine's active
    ``runtime.lockstep.LockStep``) no collective may leave the main
    thread, and every rank must issue the same ones in the same order, so
    a job is split (``microbench.calibrate``'s parts) and paced by rank
    0's decode headers (``next_step``, ``at_step``): only rank 0 polls
    the store and decides; every rank runs ``local_fn`` (the local sweeps)
    on its worker from the step whose header says so; then one comm
    sample (``sample_fn(size)`` -> (bytes, median s)) a step, run by
    every rank at the step's end on the main thread; rank 0 retries the
    comm sweep while its own fit lies below ``microbench.MIN_R2`` (up to
    ``MAX_RETRIES`` times). At the job's end every rank fits its own result
    (``last_result``; ``joined`` counts the jobs), and rank 0 alone
    stores it, reprofiles its policy and re-solves its cached plans on
    the worker (``recalibrations`` counts those, so it stays 0 on the
    other ranks): its programs reach them through the call headers. A
    ``calibrate_fn`` gives the whole result there too, and the job takes
    no comm sample. ``sample_log`` lists each comm sample this rank ran.
    """

    _JOB_KEY = ("__recalibrate__",)

    def __init__(self, cache, store, *, key=None, name: Optional[str] = None,
                 max_age_s: float = 3600.0, groups=None, device=None,
                 dtype=None, fast: bool = True,
                 refresher: Optional[PlanRefresher] = None,
                 timer: Optional[StepTimer] = None,
                 calibrate_fn: Optional[Callable[[], object]] = None,
                 poll_interval_s: float = 30.0, metrics=None,
                 lockstep=None,
                 local_fn: Optional[Callable[[], object]] = None,
                 sample_fn: Optional[Callable[[int], tuple]] = None):
        from repro_torch.profiling.store import ProfileKey
        self.cache = cache
        self.store = store
        self.dtype = dtype or torch.float32
        self.key = key if key is not None else ProfileKey.for_host(
            groups, self.dtype, device)
        self.name = name or self.key.slug()
        self.max_age_s = max_age_s
        self.groups = groups
        self.device = device
        self.fast = fast
        self.refresher = (refresher if refresher is not None
                          else PlanRefresher(cache))
        self._owns_refresher = refresher is None
        self.timer = timer
        self.calibrate_fn = calibrate_fn
        self.poll_interval_s = poll_interval_s
        self._last_poll: Optional[float] = None
        self.recalibrations = 0
        self._m_recal = None
        if metrics is not None:
            self._m_recal = metrics.counter(
                "repro_recalibrations_total",
                "completed background microbenchmark re-calibrations")
        self.lockstep = lockstep
        self.wide = lockstep is not None and lockstep.active
        self.lead = not self.wide or lockstep.lead
        self.local_fn, self.sample_fn = local_fn, sample_fn
        self.sizes: tuple = ()
        if self.wide:
            dev = torch.device(device) if device is not None else None
            self.sizes = tuple(mb.sweeps_for(
                dev if dev is not None else torch.device("cuda"),
                fast).comm)
            warmup, iters = mb.sweep_counts(fast)
            if self.local_fn is None:
                self.local_fn = partial(mb.calibrate_local, fast,
                                        self.dtype, device)
            if self.sample_fn is None:
                self.sample_fn = partial(
                    mb.measure_comm_sample, groups=groups, dtype=self.dtype,
                    device=device, warmup=warmup,
                    iters=mb.comm_iters(iters))
        self._start_pending = False
        self._job: Optional[_GroupJob] = None
        self._jobs = 0
        self.joined = 0
        self.last_result = None
        self.sample_log: List[Dict[str, float]] = []

    def due(self) -> bool:
        """True when no stored profile exists for this host's key or the
        newest one is older than ``max_age_s``."""
        try:
            return self.store.get_for_key(self.key).is_stale(self.max_age_s)
        except KeyError:
            return True

    def _poll_due(self) -> bool:
        """``due()``, read at most once per ``poll_interval_s``."""
        now = time.monotonic()
        if (self._last_poll is not None
                and now - self._last_poll < self.poll_interval_s):
            return False
        self._last_poll = now
        return self.due()

    def maybe_recalibrate(self, force: bool = False) -> bool:
        """Kick off a background re-calibration when due; returns True
        when a job was scheduled. Never blocks on the microbenchmarks. On
        a group only rank 0 decides (the others return False), and its job
        starts at its next decode header."""
        if self.wide:
            if not self.lead or self.busy:
                return False
            if not force and not self._poll_due():
                return False
            self._start_pending = True
            return True
        if not force and not self._poll_due():
            return False
        return self.refresher.request_job(self._JOB_KEY, self._recalibrate)

    def _recalibrate(self) -> None:
        if self.calibrate_fn is not None:
            result = self.calibrate_fn()
        else:
            result = mb.calibrate(name=self.name, fast=self.fast,
                                  groups=self.groups, dtype=self.dtype,
                                  device=self.device)
        self._apply(result)

    def _apply(self, result) -> None:
        """Store ``result``, reprofile the policy on its profile and
        re-solve every cached plan (stale plans keep serving)."""
        self.store.put_calibration(result, self.key, name=self.name)
        reprofile = getattr(self.cache.policy, "reprofile", None)
        if callable(reprofile):
            reprofile(result.profile)
        # every cached plan was solved under the old fit: re-solve them
        # all in place (stale plans keep serving) and restart residual
        # histories, same as a drift-recalibrating episode
        for k in self.cache.entries():
            self.cache.refresh(k)
        if self.timer is not None:
            for k in list(self.timer.keys):
                self.timer.reset_key(k)
        self.recalibrations += 1
        if self._m_recal is not None:
            self._m_recal.inc()

    # ------------------------------------------------------------------
    # a group of several ranks: the job paced by rank 0's decode headers
    # ------------------------------------------------------------------
    @property
    def busy(self) -> bool:
        """A group job is scheduled or running on this rank."""
        return self._start_pending or self._job is not None

    def next_step(self, wait: bool = False) -> CalibStep:
        """Rank 0's calibration field for this step's decode header (IDLE
        on the other ranks and on one rank): start a scheduled job, the
        next comm sample once its local sweeps are done (``wait``: block
        until they are, rather than send nothing), or the job's end."""
        if not self.wide or not self.lead:
            return IDLE
        job = self._job
        if job is None:
            if not self._start_pending:
                return IDLE
            self._start_pending = False
            return CalibStep(start=1)
        if wait:
            job.ready.wait()
        if not job.ready.is_set():
            return IDLE
        if job.error is None and job.issued < len(job.plan):
            return CalibStep(sample=job.issued, size=job.plan[job.issued])
        return CalibStep(sample=JOB_DONE)

    def at_step(self, step: CalibStep) -> None:
        """Do at this step's end what rank 0's header ``step`` says; every
        rank of the group calls this with the same ``step``."""
        if step.start:
            self._begin()
        elif step.sample >= 0:
            self._run_sample(step.sample, step.size)
        elif step.sample == JOB_DONE:
            self._end()

    def _begin(self) -> None:
        self._jobs += 1
        sizes = () if self.calibrate_fn is not None else self.sizes
        job = self._job = _GroupJob(self._jobs, sizes, list(sizes))
        fn = self.calibrate_fn or self.local_fn
        if not self.refresher.request_job(self._JOB_KEY + (job.number,),
                                          partial(self._run_local, job, fn)):
            raise RuntimeError(f"calibration job {job.number} is in flight")

    @staticmethod
    def _run_local(job: _GroupJob, fn) -> None:
        try:
            job.local = fn()
        except BaseException as e:      # noqa: BLE001 - reported at _end
            job.error = e
            raise
        finally:
            job.ready.set()

    def _run_sample(self, index: int, size: int) -> None:
        """One comm sample on the main thread, after this rank's own local
        sweeps (so that they do not share the card with it)."""
        job = self._job
        job.ready.wait()
        t0 = time.perf_counter()
        z, median_s = self.sample_fn(size)
        wall = time.perf_counter() - t0
        job.sample_s += wall
        sweep, i = divmod(index, len(job.sizes))
        if sweep == len(job.sweeps):
            job.sweeps.append(mb.MicrobenchSamples("comm"))
        job.sweeps[sweep].xs.append(z)
        job.sweeps[sweep].ts.append(median_s)
        job.issued = index + 1
        self.sample_log.append(dict(job=job.number, index=index,
                                    bytes=size, z=z, median_s=median_s,
                                    wall_s=wall))
        if self.lead and i == len(job.sizes) - 1:
            # rank 0 alone decides a retry, from its own fit; the others
            # follow the samples its headers give
            if (len(job.sweeps) <= mb.MAX_RETRIES
                    and max(self._r2(s) for s in job.sweeps) < mb.MIN_R2):
                job.plan.extend(job.sizes)

    @staticmethod
    def _r2(sweep) -> float:
        return mb.fit_nonnegative(*sweep.as_xt())[1]

    def _end(self) -> None:
        """Fit this rank's result; on rank 0 store it, reprofile and
        re-solve on the worker."""
        job, self._job = self._job, None
        job.ready.wait()
        if job.error is not None:
            return                  # the refresher counted it failed
        if self.calibrate_fn is not None:
            result = job.local
        else:
            best = max(job.sweeps, key=self._r2)
            result = mb.fit_calibration(
                self.name, job.local, best, len(job.sweeps) - 1,
                wall_s=job.local.wall_s + job.sample_s)
        self.last_result = result
        self.joined += 1
        if self.lead:
            self.refresher.request_job(self._JOB_KEY + (job.number, "fit"),
                                       partial(self._apply, result))

    def drain(self, timeout: Optional[float] = None) -> None:
        """Wait for the background work. On a group every rank calls this
        at the same point: a job rank 0 has scheduled or started runs to
        its end here, its steps carried by headers of their own."""
        if self.wide:
            while True:
                step = CalibStep(*self.lockstep.follow(
                    self.next_step(wait=True)))
                if step == IDLE:
                    break
                self.at_step(step)
        self.refresher.drain(timeout=timeout)

    def close(self) -> None:
        """Stop the worker. A group job still open is abandoned: its comm
        samples run only at step ends that every rank reaches, so no rank
        waits in one for a rank that closed."""
        self._start_pending = False
        self._job = None
        if self._owns_refresher:
            self.refresher.close()
