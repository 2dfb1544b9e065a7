"""The port's counterpart of ``repro.profiling.microbench``: the same
primitives, units, sweeps and fit, measured with PyTorch on the port's
own code paths.

Each runner times a primitive over a workload sweep and emits ``(x, t)``
samples in EXACTLY the units ``repro_torch.core.perf_model`` fits (module
header there):

  * GEMM      x = m * k * n            (product of the three GEMM dims)
  * attention y = N_h * B * S^2 * (d_k + d_v)
  * comm      z = bytes on the wire per device (a2e/e2a path)
  * decode    z = KV bytes one ragged decode step streams

``run_microbenchmarks`` bundles the sweeps into the ``measured`` dict
``fit_profile`` / ``calibrated_stage_models`` consume; ``calibrate`` goes
one step further and returns the fitted ``HardwareProfile`` plus
per-primitive R^2 (the paper reports R^2 > 0.994 on its GPUs — Fig. 7).

Where the port differs from the reference, it times what the port runs:

  * ``time_fn`` times a CUDA call with a ``torch.cuda.Event`` pair on the
    current stream, and a CPU call with ``perf_counter``;
  * attention times the port's flash kernel on a CUDA device (the port's
    prefill runs it where the reference runs ``_sdpa``), ``_sdpa`` on
    the CPU;
  * decode times the split-KV decode kernel on a CUDA device
    (``proxy=False``), its plain version on the CPU (``proxy=True``);
  * comm runs ``all_to_all_single`` over a ``core.dep.DepGroups`` expert
    group of more than one rank; otherwise the bytes-proportional copy
    proxy (``proxy=True``);
  * on a CUDA device ``calibrate`` takes ``CARD_SWEEPS``, sized so that
    each primitive's largest sample is at least 0.1 ms of the H100's work
    and at least the qwen2-moe serving shapes' (the reference's sweeps
    end below one launch there); on the CPU the reference's sweeps;
  * ``calibrate`` holds every intercept at alpha >= 0: a least-squares
    line whose intercept is negative (a negative time for small work,
    which the planner would schedule as such and lower into hints that
    put a task before its dependency) is refitted through the origin;
  * ``calibrate`` is built from parts a serving group can schedule apart:
    ``calibrate_local`` (the gemm, attn and decode sweeps, no
    collective: a worker thread may run them), ``measure_comm_sample``
    (one size of the comm sweep, run by every rank of the expert group
    at once) and ``fit_calibration``; a comm sweep is retried when rank
    0's fit says so (``lead_decides``), not the worst rank's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

import numpy as np

from repro_torch import DeviceLike, generator_for, resolve_device
from repro_torch.core.perf_model import (AlphaBeta, HardwareProfile,
                                         fit_alpha_beta)
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.attention import _causal_mask, _sdpa

# (m, k, n) GEMM sweeps: products span ~3 decades so the intercept
# (launch overhead) and slope (per-unit time) are both identifiable.
GEMM_SWEEP: Tuple[Tuple[int, int, int], ...] = (
    (128, 256, 256), (256, 512, 512), (512, 512, 1024), (512, 1024, 1024),
    (1024, 1024, 1024), (1024, 2048, 1024), (2048, 2048, 1024),
)
GEMM_SWEEP_FAST: Tuple[Tuple[int, int, int], ...] = (
    (128, 256, 256), (256, 256, 512), (256, 512, 512), (512, 512, 512),
    (512, 1024, 512), (512, 1024, 1024), (1024, 1024, 1024),
)

# (B, S, N_h, d) attention sweeps (d_k = d_v = d).
ATTN_SWEEP: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 128, 4, 64), (1, 256, 4, 64), (2, 256, 4, 64), (2, 512, 4, 64),
    (4, 512, 4, 64), (4, 512, 8, 64),
)
ATTN_SWEEP_FAST: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 64, 4, 64), (1, 128, 4, 64), (2, 128, 4, 64), (2, 256, 4, 64),
    (4, 256, 4, 64),
)

# per-device payload sizes (bytes) for the comm sweep
COMM_SWEEP_BYTES: Tuple[int, ...] = tuple(2 ** i for i in range(16, 26))
COMM_SWEEP_BYTES_FAST: Tuple[int, ...] = tuple(2 ** i for i in range(20, 26))

# (B, C, fill) single-query ragged decode sweeps at fixed (Kv, D): B rows
# each attending fill*C cached positions. The unit is BYTES STREAMED
# (sum(lengths) * Kv * 2D * itemsize) — decode attention is
# bandwidth-bound, so its alpha-beta lives on a different line than the
# compute-bound prefill attention fit.
DECODE_SWEEP: Tuple[Tuple[int, int, float], ...] = (
    (1, 256, 1.0), (2, 256, 0.5), (2, 512, 1.0), (4, 512, 0.5),
    (4, 1024, 1.0), (8, 1024, 0.75), (8, 2048, 0.5),
)
DECODE_SWEEP_FAST: Tuple[Tuple[int, int, float], ...] = (
    (1, 128, 1.0), (2, 128, 0.5), (2, 256, 1.0), (4, 256, 0.5),
    (4, 512, 0.5),
)
DECODE_KV_HEADS = 4
DECODE_HEAD_DIM = 64


class Sweeps(NamedTuple):
    """One sweep per primitive, and the (Kv, D) the decode sweep runs at."""

    gemm: Sequence[Tuple[int, int, int]]
    attn: Sequence[Tuple[int, int, int, int]]
    comm: Sequence[int]
    decode: Sequence[Tuple[int, int, float]]
    decode_heads: Tuple[int, int] = (DECODE_KV_HEADS, DECODE_HEAD_DIM)


REFERENCE_SWEEPS = Sweeps(GEMM_SWEEP, ATTN_SWEEP, COMM_SWEEP_BYTES,
                          DECODE_SWEEP)
REFERENCE_SWEEPS_FAST = Sweeps(GEMM_SWEEP_FAST, ATTN_SWEEP_FAST,
                               COMM_SWEEP_BYTES_FAST, DECODE_SWEEP_FAST)

#: the sweeps of a CUDA device. Each spans at least two decades of its
#: unit, and its largest sample is at least 0.1 ms of the H100's work and
#: at least the work of the qwen2-moe serving shapes it stands for: the
#: expert GEMM at C = 204 (60 experts: 1.1e11 m·k·n), flash at the prefill
#: bucket of 1024 with 16 heads at D = 128, decode over 8 rows of 1024 at
#: Kv = 16 (bf16 bytes: 67 MB).
CARD_SWEEPS = Sweeps(
    gemm=((1024, 1024, 1024), (2048, 1024, 1024), (2048, 2048, 1024),
          (2048, 2048, 2048), (4096, 2048, 2048), (4096, 4096, 2048),
          (4096, 4096, 4096), (8192, 4096, 4096), (8192, 8192, 4096)),
    attn=((1, 512, 16, 128), (1, 1024, 16, 128), (2, 1024, 16, 128),
          (1, 2048, 16, 128), (2, 2048, 16, 128), (4, 2048, 16, 128),
          (2, 4096, 16, 128), (4, 4096, 16, 128)),
    comm=tuple(2 ** i for i in range(20, 29)),
    decode=((1, 256, 1.0), (1, 1024, 1.0), (2, 1024, 1.0), (4, 1024, 1.0),
            (8, 1024, 1.0), (8, 2048, 1.0), (8, 4096, 1.0),
            (16, 4096, 1.0)),
    decode_heads=(16, 128))


def sweeps_for(device: torch.device, fast: bool) -> Sweeps:
    """``CARD_SWEEPS`` on a CUDA device, else the reference's sweeps."""
    if device.type == "cuda":
        return CARD_SWEEPS
    return REFERENCE_SWEEPS_FAST if fast else REFERENCE_SWEEPS


#: cycles of the spin kernel that holds the stream before a timed CUDA
#: call (about 0.5 ms on an H100): the start event is recorded behind it,
#: so the event pair brackets the call's device time and not the host's
#: time to enqueue it, which is longer than a small kernel
_HOLD_CYCLES = 1_000_000


def time_fn(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median seconds per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls (the median discards scheduler hiccups that would
    poison a mean on shared hosts). A call on CUDA tensors is timed by a
    ``torch.cuda.Event`` pair on the current stream, held busy ahead of
    the call (``_HOLD_CYCLES``); a CPU call by ``perf_counter``."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    for _ in range(max(warmup, 0)):
        fn(*args)
    ts = []
    for _ in range(max(iters, 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_HOLD_CYCLES)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    ts.sort()
    n = len(ts)
    return ts[n // 2] if n % 2 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])


@dataclass
class MicrobenchSamples:
    """One primitive's measured sweep: ``xs`` in perf_model units, ``ts``
    in seconds. ``proxy`` flags a stand-in measurement (e.g. the comm
    sweep on a single-device host)."""

    kind: str
    xs: List[float] = field(default_factory=list)
    ts: List[float] = field(default_factory=list)
    proxy: bool = False

    def as_xt(self) -> Tuple[List[float], List[float]]:
        return self.xs, self.ts


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def measure_gemm(shapes: Optional[Sequence[Tuple[int, int, int]]] = None,
                 dtype=None, device: DeviceLike = None, warmup: int = 2,
                 iters: int = 5) -> MicrobenchSamples:
    """x = m*k*n for a [m,k] @ [k,n] ``torch.matmul`` (a library product,
    as the reference times a plain ``a @ b``)."""
    dev = resolve_device(device)
    dtype = dtype or torch.float32
    shapes = GEMM_SWEEP if shapes is None else shapes
    out = MicrobenchSamples("gemm")
    gen = generator_for(dev, 0)
    for m, k, n in shapes:
        a = _randn(gen, (m, k), dtype, dev)
        b = _randn(gen, (k, n), dtype, dev)
        out.xs.append(float(m * k * n))
        out.ts.append(time_fn(torch.matmul, a, b, warmup=warmup,
                              iters=iters))
    return out


def measure_attention(shapes: Optional[Sequence[Tuple[int, int, int, int]]]
                      = None, dtype=None, device: DeviceLike = None,
                      warmup: int = 2, iters: int = 5) -> MicrobenchSamples:
    """y = N_h * B * S^2 * (d_k + d_v) for causal attention: the flash
    kernel on a CUDA device, ``_sdpa`` on the CPU."""
    dev = resolve_device(device)
    dtype = dtype or torch.float32
    shapes = ATTN_SWEEP if shapes is None else shapes
    out = MicrobenchSamples("attn")
    gen = generator_for(dev, 0)
    for B, S, H, D in shapes:
        q, k, v = (_randn(gen, (B, S, H, D), dtype, dev) for _ in range(3))
        out.xs.append(float(H * B * S * S * (D + D)))
        if dev.type == "cuda":
            t = time_fn(flash_attention, q, k, v, warmup=warmup, iters=iters)
        else:
            pos = torch.arange(S, device=dev)
            t = time_fn(_sdpa, q, k, v, _causal_mask(pos, pos),
                        warmup=warmup, iters=iters)
        out.ts.append(t)
    return out


def measure_comm_sample(size_bytes: int, groups=None, dtype=None,
                        device: DeviceLike = None, warmup: int = 2,
                        iters: int = 15) -> Tuple[float, float]:
    """One sample of the comm sweep: (z, median seconds) of one
    ``all_to_all_single`` over the expert group of ``groups`` (a
    ``core.dep.DepGroups``) moving ``size_bytes`` a rank — a local
    [mo, c] buffer, one [c] row to each of the mo peers, like one a2e
    chunk of Eq. 4: the live-wire measurement. Every rank of the expert
    group must call it with the same size. On a group of one rank, a
    bytes-proportional on-device copy stands in (``measure_all_to_all``
    flags it ``proxy``)."""
    dev = resolve_device(device)
    dtype = dtype or torch.float32
    itemsize = torch.empty((), dtype=dtype).element_size()
    mo = groups.expert_size if groups is not None else 1
    gen = generator_for(dev, 0)
    elems = max(int(size_bytes) // itemsize, mo * mo)
    if mo > 1:
        c = max(elems // mo, 1)
        x = _randn(gen, (mo, c), dtype, dev)
        f = partial(dist.all_to_all_single, torch.empty_like(x),
                    group=groups.expert)
        z = float(mo * c * itemsize)
    else:
        # proxy: a bytes-proportional on-device copy. Keeps the fit
        # machinery exercised on hosts with no multi-rank group; the
        # resulting beta is HBM-ish, NOT a wire bandwidth.
        x = _randn(gen, (elems,), dtype, dev)
        f = partial(torch.add, other=1)
        z = float(elems * itemsize)
    return z, time_fn(f, x, warmup=warmup, iters=iters)


def measure_all_to_all(groups=None,
                       sizes_bytes: Optional[Sequence[int]] = None,
                       dtype=None, device: DeviceLike = None,
                       warmup: int = 2, iters: int = 5) -> MicrobenchSamples:
    """z = bytes per rank moved by one ``all_to_all_single`` over the
    expert group of ``groups``, one ``measure_comm_sample`` per size —
    the live-wire measurement. Falls back to an on-device copy proxy
    (``proxy=True``) when the group has one rank."""
    sizes = COMM_SWEEP_BYTES if sizes_bytes is None else sizes_bytes
    out = MicrobenchSamples(
        "comm", proxy=groups is None or groups.expert_size <= 1)
    for z in sizes:
        x, t = measure_comm_sample(z, groups, dtype=dtype, device=device,
                                   warmup=warmup, iters=iters)
        out.xs.append(x)
        out.ts.append(t)
    return out


def measure_decode_attention(shapes: Optional[Sequence[Tuple[int, int, float]]]
                             = None, dtype=None, device: DeviceLike = None,
                             warmup: int = 2, iters: int = 5,
                             heads: Tuple[int, int] = (DECODE_KV_HEADS,
                                                       DECODE_HEAD_DIM)
                             ) -> MicrobenchSamples:
    """z = sum(lengths) * Kv * (d_k + d_v) * itemsize — the KV bytes one
    ragged decode step streams, at ``heads`` = (Kv, D) with one query
    head per KV head. Times the split-KV decode kernel on a CUDA device;
    on the CPU its plain version stands in (``proxy=True``): the CPU
    does not measure the card's memory system."""
    dev = resolve_device(device)
    dtype = dtype or torch.float32
    shapes = DECODE_SWEEP if shapes is None else shapes
    kv, d = heads
    itemsize = torch.empty((), dtype=dtype).element_size()
    out = MicrobenchSamples("decode", proxy=dev.type != "cuda")
    gen = generator_for(dev, 0)
    for B, C, fill in shapes:
        # size the cache to the occupied length (rather than masking a
        # full-C cache): the plain version computes all C positions and
        # masks, which would decouple its time from the bytes unit; the
        # kernel skips past-length chunks anyway, so both paths stream
        # exactly the bytes the sample claims
        c_eff = max(int(C * fill), 16)
        q = _randn(gen, (B, kv, d), dtype, dev)
        k = _randn(gen, (B, c_eff, kv, d), dtype, dev)
        v = _randn(gen, (B, c_eff, kv, d), dtype, dev)
        lens = torch.full((B,), c_eff, dtype=torch.int32, device=dev)
        out.xs.append(float(B * c_eff * kv * 2 * d * itemsize))
        out.ts.append(time_fn(decode_attention, q, k, v, lens,
                              warmup=warmup, iters=iters))
    return out


def _measure_kind(kind: str, sweeps: Sweeps, groups, dtype, device,
                  warmup: int, iters: int) -> MicrobenchSamples:
    if kind == "gemm":
        return measure_gemm(sweeps.gemm, dtype=dtype, device=device,
                            warmup=warmup, iters=iters)
    if kind == "attn":
        return measure_attention(sweeps.attn, dtype=dtype, device=device,
                                 warmup=warmup, iters=iters)
    if kind == "comm":
        return measure_all_to_all(groups, sweeps.comm, dtype=dtype,
                                  device=device, warmup=warmup,
                                  iters=comm_iters(iters))
    if kind == "decode":
        return measure_decode_attention(
            sweeps.decode, dtype=dtype, device=device, warmup=warmup,
            iters=iters, heads=sweeps.decode_heads)
    raise ValueError(f"unknown microbench kind {kind!r}")


#: the full primitive set ``calibrate`` sweeps (decode rides along as the
#: optional fourth alpha-beta — ``fit_profile`` treats it as such)
MICROBENCH_KINDS = ("gemm", "attn", "comm", "decode")
#: the primitives a rank measures on its own (no collective)
LOCAL_KINDS = ("gemm", "attn", "decode")
#: a sweep fitting below this R^2 is re-measured, at most MAX_RETRIES
#: times (``calibrate``'s retry rule)
MIN_R2 = 0.9
MAX_RETRIES = 2


def comm_iters(iters: int) -> int:
    """Timed calls of a comm sample for ``iters`` of a compute sample: comm
    samples are the cheapest to take and (on the copy proxy) the most
    scheduler-noise-prone — buy stability with extra iters."""
    return max(3 * iters, 15)


def sweep_counts(fast: bool, warmup: Optional[int] = None,
                 iters: Optional[int] = None) -> Tuple[int, int]:
    """(warm-up, timed) calls a sample: the given ones, else 1 + 5 for the
    fast sweeps and 2 + 9 for the full ones."""
    return ((1 if fast else 2) if warmup is None else warmup,
            (5 if fast else 9) if iters is None else iters)


def run_microbenchmarks(fast: bool = False, groups=None, dtype=None,
                        device: DeviceLike = None,
                        warmup: Optional[int] = None,
                        iters: Optional[int] = None,
                        kinds: Tuple[str, ...] = MICROBENCH_KINDS
                        ) -> Dict[str, MicrobenchSamples]:
    """The full sweep set (``sweeps_for(device, fast)``), keyed by
    primitive — ``{k: v.as_xt() ...}`` is exactly the ``measured`` dict
    ``calibrated_stage_models`` expects."""
    dev = resolve_device(device)
    warmup, iters = sweep_counts(fast, warmup, iters)
    sweeps = sweeps_for(dev, fast)
    return {kind: _measure_kind(kind, sweeps, groups, dtype, dev, warmup,
                                iters)
            for kind in kinds}


@dataclass
class CalibrationResult:
    profile: HardwareProfile
    fit_r2: Dict[str, float]             # per primitive
    samples: Dict[str, MicrobenchSamples]
    wall_s: float
    #: re-measures per primitive (the retry rule of ``calibrate``)
    retries: Dict[str, int] = field(default_factory=dict)

    @property
    def comm_is_proxy(self) -> bool:
        return self.samples["comm"].proxy

    def min_r2(self) -> float:
        return min(self.fit_r2.values())


def fit_nonnegative(xs: Sequence[float], ts: Sequence[float]
                    ) -> Tuple[AlphaBeta, float]:
    """``fit_alpha_beta``, unless its intercept is negative: then the
    least-squares line through the origin (alpha = 0). Returns the model
    and its R^2."""
    ab, r2 = fit_alpha_beta(xs, ts)
    if ab.alpha >= 0:
        return ab, r2
    x = np.asarray(xs, dtype=np.float64)
    t = np.asarray(ts, dtype=np.float64)
    beta = float(x @ t / (x @ x))
    ss_res = float(np.sum((t - beta * x) ** 2))
    ss_tot = float(np.sum((t - t.mean()) ** 2))
    return AlphaBeta(0.0, beta), 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0


def fit_samples(samples: Dict[str, MicrobenchSamples], name: str
                ) -> Tuple[HardwareProfile, Dict[str, float]]:
    """The profile (``fit_nonnegative`` per primitive; decode optional, as
    in ``fit_profile``) and each primitive's R^2."""
    fits = {kind: fit_nonnegative(*s.as_xt()) for kind, s in samples.items()}
    profile = HardwareProfile(
        name, gemm=fits["gemm"][0], attn=fits["attn"][0],
        comm=fits["comm"][0],
        decode=fits["decode"][0] if "decode" in fits else None)
    return profile, {kind: r2 for kind, (_, r2) in fits.items()}


def lead_decides(flag: bool, groups) -> bool:
    """Rank 0's ``flag`` on every rank of ``groups`` (a broadcast over its
    gloo ``control`` group); ``flag`` itself on a group of one rank."""
    if groups is None or groups.world_size <= 1:
        return flag
    buf = torch.tensor([int(flag)], dtype=torch.int64)
    dist.broadcast(buf, src=0, group=groups.control
                   if groups.control is not None else groups.world)
    return bool(buf.item())


def _best_sweep(measure: Callable[[], MicrobenchSamples], min_r2: float,
                max_retries: int, decide: Callable[[bool], bool] = bool
                ) -> Tuple[MicrobenchSamples, int]:
    """``measure()``, re-measured up to ``max_retries`` times while
    ``decide(R^2 < min_r2)`` says so (scheduler noise hit the sweep — a
    transient, not a property of the hardware), keeping the best-R^2
    sweep. Returns it and the re-measures."""
    best = measure()
    r2 = fit_nonnegative(*best.as_xt())[1]
    n = 0
    while n < max_retries and decide(r2 < min_r2):
        again = measure()
        n += 1
        r2_again = fit_nonnegative(*again.as_xt())[1]
        if r2_again > r2:
            best, r2 = again, r2_again
    return best, n


@dataclass
class LocalCalibration:
    """The part of a calibration a rank takes on its own: the gemm, attn
    and decode sweeps (no collective), their re-measures and wall s."""

    samples: Dict[str, MicrobenchSamples]
    retries: Dict[str, int]
    wall_s: float


def calibrate_local(fast: bool = False, dtype=None,
                    device: DeviceLike = None, min_r2: float = MIN_R2,
                    max_retries: int = MAX_RETRIES,
                    warmup: Optional[int] = None,
                    iters: Optional[int] = None) -> LocalCalibration:
    """The local sweeps of ``calibrate`` (``LOCAL_KINDS`` over
    ``sweeps_for(device, fast)``), each re-measured on this rank alone
    while it fits below ``min_r2``. Issues no collective, so it may run
    on a worker thread beside a serving one."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    warmup, iters = sweep_counts(fast, warmup, iters)
    sweeps = sweeps_for(dev, fast)
    samples, retries = {}, {}
    for kind in LOCAL_KINDS:
        samples[kind], retries[kind] = _best_sweep(
            partial(_measure_kind, kind, sweeps, None, dtype, dev, warmup,
                    iters), min_r2, max_retries)
    return LocalCalibration(samples, retries, time.perf_counter() - t0)


def fit_calibration(name: str, local: LocalCalibration,
                    comm: MicrobenchSamples, comm_retries: int = 0,
                    wall_s: Optional[float] = None) -> CalibrationResult:
    """Join a rank's local part and its comm sweep into the fitted
    ``CalibrationResult`` (``fit_samples``); ``wall_s`` defaults to the
    local part's."""
    samples = dict(local.samples, comm=comm)
    samples = {k: samples[k] for k in MICROBENCH_KINDS}
    profile, r2s = fit_samples(samples, name)
    return CalibrationResult(
        profile=profile, fit_r2=r2s, samples=samples,
        wall_s=local.wall_s if wall_s is None else wall_s,
        retries=dict(local.retries, comm=comm_retries))


def calibrate(name: str = "calibrated", fast: bool = False, groups=None,
              dtype=None, device: DeviceLike = None,
              min_r2: float = MIN_R2, max_retries: int = MAX_RETRIES,
              warmup: Optional[int] = None,
              iters: Optional[int] = None) -> CalibrationResult:
    """Measure -> fit: the paper's offline phase on ``device`` (None: the
    card) under ``groups``. Returns the fitted profile (``fit_samples``:
    intercepts held at >= 0) + the R^2 quality of each primitive fit.

    Built from its parts: the comm sweep (one ``measure_comm_sample`` per
    size of ``sweeps_for(device, fast).comm``), then ``calibrate_local``,
    then ``fit_calibration``. The collectives come first: a rank that
    returns straight after its last one may tear its group down while a
    peer still reads from it. A primitive whose fit lands
    below ``min_r2`` is re-measured up to ``max_retries`` times, keeping
    the best-R^2 sweep; ``min_r2=0`` disables retries. Every rank of
    ``groups`` must call this: a local primitive is re-measured on its own
    rank, and the comm sweep on every rank when it fits below ``min_r2``
    on rank 0 (``lead_decides``), so a retried all_to_all is issued by
    all of them."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    warmup, iters = sweep_counts(fast, warmup, iters)
    comm, retries = _best_sweep(
        partial(_measure_kind, "comm", sweeps_for(dev, fast), groups, dtype,
                dev, warmup, iters), min_r2, max_retries,
        partial(lead_decides, groups=groups))
    local = calibrate_local(fast, dtype, dev, min_r2, max_retries, warmup,
                            iters)
    return fit_calibration(name, local, comm, retries,
                           wall_s=time.perf_counter() - t0)
