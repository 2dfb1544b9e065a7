#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it, in phases.

  1. build    compile the CUDA kernels from src/repro_torch/csrc (nvcc,
              sm_90a), print the seconds taken per source and ptxas's
              registers and spills per kernel, and count the HGMMA
              (wgmma) instructions in the SASS of each tensor-core kernel
              (none fails the run);
  2. kernels  hold each hand-written kernel against its plain PyTorch
              version at the serving path's shapes, in bf16 and f32, and
              time the kernel, the plain version, one PyTorch library call
              of the same function (CUDA events, and for the redesigned
              kernels also the profiler's device time, the scans and
              decode attention also with a cold L2), and the card's
              bound for the work; time the bf16 expert GEMM at each
              decode-sized C; hold bf16 flash to a limit that a window
              or diagonal off by one fails, bf16 decode attention to one
              that a length off by one fails, the bf16 expert GEMM to one
              that a dropped k16 slice, a cut tile or a swapped expert
              fails, and the mLSTM scan's chunkwise route to f32 limits
              that a state entering late or a mask one step too wide
              fails (shown by controls); m and the RG-LRU scan's f32
              output must be bitwise the plain versions';
  3. small    a smoke-size model on the card (kernels) against the same
              model on the CPU (plain versions): prefill and decode logits
              and greedy tokens;
     ring     recurrentgemma-9b at full width cut to one (rec, rec, attn)
              group, f32 weights: teacher-forced decode across the local
              attention ring's wrap against prefill of the longer prompt;
  4. calibrate  the port's microbenchmarks (``profiling.calibrate``) on the
              card at bf16 over the card's sweeps: the expert path's
              GEMMs (``torch.matmul``), the flash kernel (attention) and
              the split-KV decode kernel (decode), and the copy proxy for
              the all_to_all (one card has no wire); print every
              sample, alpha, beta, R^2, proxy flag and retries, and the
              rate beta implies beside the card's peak; fail if a
              non-proxy fit has R^2 under 0.9 or beta <= 0, if either
              kernel's launches differ from the sweep's calls, or if the
              profile stored in a fresh ``ProfileStore`` does not load
              back bit for bit;
     serve    ServingEngine with the full qwen2-moe-a2.7b config (24
              layers, bf16 weights drawn from a seed on the card): 16
              requests, 8 slots, max_context 1024, on three paths, each
              run with the decode step as a CUDA graph and with the
              launch counts set to 0 just before it and read just after
              (a graph engine must replay once per decode step and
              capture no key twice): paged KV with the dense footprint as
              its pool ("paged"); dense KV ("serve"), whose greedy tokens
              the paged run must equal; paged KV under a pool that must
              preempt, with a shared system prompt ("pressure"). Each
              path is held against an eager engine (decode_graph=False)
              on the same weights: the eager engine serves the same
              requests (greedy tokens must be equal) and both take 11
              teacher-forced decode steps over 8 prompts of mixed lengths
              (logits must be bitwise equal at every step; on the paged
              paths a step must follow a table change). Paged and serve
              are profiled over 3 decode steps, graph and eager (serve
              also over one batched prefill call of 8 x 300 tokens); a
              paired decode-step timing takes turns between the dense
              graph, dense eager and paged graph engines;
     dep      the same model, weights and requests with the FinDEP
              policy on the profile the calibrate phase measured (its
              plans printed beside the PAPER_A6000 ones at every prefill
              (bucket, batch) and decode occupancy met) and an NCCL
              expert group of one rank: every MoE layer walks its plan's
              program (A2E /
              EXP / E2A per (stream, chunk), all_to_all on a comm
              stream); the expert GEMM must launch 24 x sum(r1·r2) of
              each step's programs; graph against eager (greedy tokens,
              11 teacher-forced steps bitwise), interleave "streams"
              against "off" bitwise, one full-width layer against the
              capacity path (bitwise where r2 = 1 and the shared expert
              is one segment, else within GEMM_TOL); plans, captures per
              key, a decode-step and a prefill profile, expert-GEMM ms
              per launch at the chunk widths, and a paired timing of the
              DEP graph engine against the capacity graph engine; the
              engine's telemetry (measured against predicted seconds, per
              phase and per plan key);
     drift    on the same weights and requests, a dep engine with a
              drift threshold and a re-calibration whenever its store
              is older than 0 s (polled every ``DRIFT_POLL_S``): the
              calibration runs on the refresh worker, on its own stream,
              while the engine serves; every request must finish, the
              graph replay once per decode step and capture no key
              twice, the expert GEMM launch 24 x sum(r1·r2), and at
              least one re-calibration and one re-solve land before the
              serve ends; drift events, re-solves, re-calibrations and
              the programs first captured mid-serve are printed;
     obs      the port's entry point, ``repro_torch.launch.serve_moe``,
              serves the same model (--full --dep, 16 requests, 8 slots,
              max_context 1024, the calibrate phase's profile) with
              --trace-out and --metrics-out: the trace must validate and
              hold every span, the JSONL and the Prometheus text parse
              back with a TTFT count of every finished request; an
              untraced twin (tracer=None, metrics=False) on the same
              weights must give the same greedy tokens and graph keys,
              and both the same host launch calls per decode step (1
              cudaGraphLaunch, 2 cudaLaunchKernel). Then one MoE layer
              of those weights is traced on the card
              (``trace_dep_execution``: CUDA event pairs, A2E/E2A on the
              comm stream, EXP/SHARED on the compute stream) under the
              8 x 300 prefill's planned program and the forced r1=2 x
              r2=4 one, each interleaved and not: spans in walk order,
              one EXP per (stream, chunk), output bitwise the untraced
              layer's, each A2E/E2A span at least its copy's bytes
              bound; per-kind device ms, executed against scheduled
              exposed comm and the comm-under-EXP share are printed;
  5. xlstm    ServingEngine with the full xlstm-1.3b config (48 layers,
              42 mLSTM through the mLSTM scan kernels, 6 sLSTM): 16
              requests, 8 slots, max_context 1024, with the graph; held
              against an eager engine as in phase 4 and timed beside it;
              profiled over 3 decode steps (graph and eager) and one
              600-token prefill call;
  6. hybrid   ServingEngine with the full recurrentgemma-9b config (38
              layers: 26 RG-LRU through the RG-LRU scan kernel, 12 local
              attention through the flash kernel at prefill and over a
              ring KV cache at decode): 16 requests, 8 slots,
              max_context 4096, one prompt whose ring wraps in decode and
              one whose prefill rolls, with the graph; held against an
              eager engine (a teacher-forced ring wraps) and timed beside
              it; profiled over 3 decode steps (graph and eager) and one
              3000-token prefill call;
  7. report   one JSON line with every kernel's numbers (launches from the
              dep path for the kernels of qwen2-moe's dense KV), the
              card's name and power limit, and as the last line
              {"ok": true, "device": ...}.

Any failure ends the run with a traceback and a non-zero exit. Without a
CUDA device it exits non-zero and prints no result.

Run from the repository root:  python3 chip_smoke.py
(``--no-serve`` stops after phase 3 and the ring check: a quick check of
new kernels.) The calibration's profile store is a temporary directory
under ``.repro-profiles/``, removed at the end.
``python3 tools/rehearse_chip_smoke.py`` runs phases 4-6 on the CPU at
smoke size, with a stand-in for the CUDA graph and a gloo expert group.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import generator_for  # noqa: E402
from repro_torch import kernels as kernel_lib  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import DepClusterConfig  # noqa: E402
from repro_torch.core.analytic import StageTimes  # noqa: E402
from repro_torch.core.dep import DepGroups, moe_apply_dep  # noqa: E402
from repro_torch.core.perf_model import PAPER_A6000  # noqa: E402
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig  # noqa: E402
from repro_torch.core.taskgraph import (ExecProgram, TaskCosts,  # noqa: E402
                                        lower_exec, schedule)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_attention_paged)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, gather_pages, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as mlstm_kernel  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan  # noqa: E402
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref  # noqa: E402
from repro_torch.kernels.moe_gemm import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.moe_gemm.ops import moe_gemm  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref  # noqa: E402
from repro_torch.kernels.rg_lru import kernel as rglru_kernel  # noqa: E402
from repro_torch.kernels.rg_lru.ops import rg_lru_scan  # noqa: E402
from repro_torch.kernels.rg_lru.ref import rg_lru_scan_ref  # noqa: E402
from repro_torch.models import ExecutionContext, build_model  # noqa: E402
from repro_torch.launch import serve_moe  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.obs import (attribute_overlap, interval_subtract,  # noqa: E402
                             interval_total, interval_union, lane_intervals,
                             parse_prometheus, trace_dep_execution,
                             validate_chrome_trace)
from repro_torch.profiling import (ProfileKey, ProfileStore,  # noqa: E402
                                   calibrate)
from repro_torch.profiling.microbench import sweeps_for  # noqa: E402
from repro_torch.runtime import Request, RequestState, ServingEngine  # noqa: E402
from repro_torch.runtime.engine import prefill_split  # noqa: E402
from repro_torch.sched import FinDEPPolicy, PlanCache  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet; dense, full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# f32: summation order differs; bf16: the reference's kernel tolerance
# (tests/test_kernels.py:19-20)
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=5e-2)}
# bf16 flash: a typical output is 0.04-0.3 in size, so the reference's
# atol of 5e-2 would pass a mask off by one key. The kernel rounds P to
# bf16 as the reference does (flash_attention/kernel.py:76) and the plain
# version does not; on rows that see a few keys that moves a small output
# by a few 1e-3, so atol is 5e-3 (the worst ratio each check prints is
# the margin). check_flash_controls shows that an off-by-one mask fails
# this limit.
FLASH_TOL = {torch.float32: TOL[torch.float32],
             torch.bfloat16: dict(rtol=2e-2, atol=5e-3)}
# bf16 decode attention: an output row over 300-1024 positions is 0.05-0.1
# in size, so the reference's atol of 5e-2 would pass a row that drops or
# adds a position (~3e-3 of change in its typical entry). Kernel and plain
# version both round an f32 result to bf16, so a sound output differs by
# at most one bf16 step (2^-7 relative), which rtol covers; atol 2e-3
# only has to cover entries near zero. check_decode_controls shows that a
# length off by one, or a chunk read one position late, fails this limit.
DECODE_TOL = {torch.float32: TOL[torch.float32],
              torch.bfloat16: dict(rtol=2e-2, atol=2e-3)}
# bf16 expert GEMM: an output entry is about 0.6 in size at check_moe_gemm's
# inputs, so TOL's atol of 5e-2 is a tenth of an entry. The kernel stores
# y in bf16 as the plain version does (at most one bf16 step apart, 2^-7
# relative, which rtol covers) and also rounds the SwiGLU activation to
# bf16 before the down product (the Pallas kernel does too, the plain
# version does not), a few 1e-3 on entries near zero, which atol covers.
# check_moe_gemm_controls shows that one k16 slice of the gate/up
# reduction dropped, the down reduction cut by one 64-deep tile, or one
# expert's weights swapped for its neighbour's fails this limit in every
# row it changes.
GEMM_TOL = {torch.float32: TOL[torch.float32],
            torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


def fail(msg: str):
    raise RuntimeError(msg)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def is_annotation(e) -> bool:
    """A device event that marks a collective's span ("nccl:all_to_all")
    over the copies or kernels it ran, not a kernel of its own."""
    return e.name.startswith("nccl:")


def device_events(prof):
    """The profiler's device events: kernels, copies and sets, without
    the collectives' span annotations."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not is_annotation(e)]


#: device events per wrapper call of the repo's kernels, by the name
#: filter ``device_ms`` is given: two launches for the expert GEMM (SwiGLU,
#: then down) and decode attention (split, then combine), one otherwise
PER_CALL = {"decode_attention_": 2, "decode_attention_split": 1,
            "decode_attention_combine": 1, "moe_gemm_": 2,
            "flash_attention_": 1, "mlstm_chunk_prep": 1,
            "mlstm_chunk_scan": 1, "rg_lru_scan": 1}


def trace_span(prof) -> str:
    """Where a trace's device events lie against its host events (us from
    the first host event): what a short trace lost."""
    host = [e.time_range for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CUDA]
    dev = [e.time_range for e in device_events(prof)]
    if not host or not dev:
        return f"{len(host)} host and {len(dev)} device events"
    t0 = min(r.start for r in host)
    return (f"host events {0:.0f}..{max(r.end for r in host) - t0:.0f} us, "
            f"device events {min(r.start for r in dev) - t0:.0f}.."
            f"{max(r.end for r in dev) - t0:.0f} us")


def device_ms(fn, kernel=None, iters: int = 10, per_call=None,
              bound=None) -> float:
    """Mean device time per call of ``fn`` of the kernels whose name
    contains ``kernel`` (every device kernel of the call when ``kernel``
    is None), from torch.profiler: unlike ``time_ms`` it holds no host
    time, which dominates a kernel of a few microseconds.

    The profiler now and then drops device events, which reads short. So
    a trace counts only when it holds every event: ``per_call`` (default
    ``PER_CALL[kernel]``) matching events per call, or, where that is not
    known (plain versions, library calls), a count that an earlier trace
    of the same calls gave too. A short trace is taken again, six in
    all; then the reading fails. A reading below ``bound`` (ms, the least
    time the card could take) fails too."""
    if per_call is None:
        per_call = PER_CALL.get(kernel)
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(6):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in device_events(prof)
                  if kernel is None or kernel in e.name]
        n = len(events)
        if per_call is not None:
            whole = n == per_call * iters
        else:
            whole = n > 0 and n % iters == 0 and n in seen
        seen.append(n)
        if whole:
            ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
            break
        if per_call is not None or len(seen) > 1:
            print(f"  device_ms: {n} {kernel or 'device'} events in a trace "
                  f"of {iters} calls; {trace_span(prof)}; again")
    else:
        want = (f"{per_call * iters}" if per_call is not None
                else "two traces that agree")
        fail(f"device_ms: no whole trace of {kernel or 'the kernels'} in "
             f"{len(seen)}: {seen} device events, want {want}")
    if bound is not None and ms < bound:
        fail(f"device_ms: {kernel or 'the kernels'} read {ms:.4f} ms, below "
             f"the card's bound of {bound:.4f} ms")
    return ms


def timed(fn, kernel=None, iters: int = 10, per_call=None,
          bound=None) -> tuple:
    """(CUDA-event ms, profiler device ms) of ``fn``."""
    return time_ms(fn, iters=iters), device_ms(fn, kernel, iters=iters,
                                               per_call=per_call,
                                               bound=bound)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _worst(g, w, tol) -> float:
    """The largest |g - w| over its limit atol + rtol |w|: above 1 fails."""
    return float(((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs()))
                 .max())


def compare(name: str, got, want, dtype, tol=None) -> float:
    tol = tol or TOL[dtype]
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
             f"version {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max())
    worst = _worst(g, w, tol)
    ok = torch.allclose(g, w, **tol)
    print(f"  {name}: max_abs_err={err:.3e} (rtol={tol['rtol']}, "
          f"atol={tol['atol']}; worst {worst:.2f} of the limit) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def randn(gen, shape, dtype, scale=1.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

#: the tensor-core kernels, by the name their SASS functions carry
WGMMA_KERNELS = ("moe_gemm_wgmma_kernel", "flash_attention_wgmma_kernel")


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load_library()
    dt = time.perf_counter() - t0
    info = build.last_build
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    print(f"[build] {'compiled' if info.get('compiled') else 'cached'} "
          f"{len(build.sources())} sources into {build.library_path().name}"
          f" in {dt:.1f} s ({nvcc.strip().splitlines()[-1]})")
    for name, secs in info.get("per_source", {}).items():
        print(f"  {name}: {secs:.1f} s")
    for line in ptxas_summary(str(info.get("report", ""))):
        print("  " + line)
    sass_hgmma()


def _demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True)
    out = res.stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def ptxas_summary(report: str):
    """One line per compiled kernel from ptxas -v: registers, spills,
    shared memory; and every ptxas warning (e.g. a serialised wgmma)."""
    rows, cur, lines = [], None, []
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = [m.group(1), "", ""]
            rows.append(cur)
        elif cur is not None and "spill stores" in line:
            cur[1] = line.strip()
        elif cur is not None and "Used" in line and "registers" in line:
            cur[2] = line.split(":", 1)[-1].strip()
        if "warning" in line.lower():
            lines.append("ptxas " + line.strip())
    for (_, spill, used), name in zip(rows, _demangle([r[0] for r in rows])):
        lines.append(f"{_short(name)}: {used}; {spill}")
    return lines


def _short(name: str) -> str:
    """A demangled kernel name without namespace, return type or
    parameter list: ``moe_gemm_wgmma_kernel<true>``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(")[0][:70]


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    beside = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if os.path.exists(beside):
        return beside
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        path = os.path.join(os.path.dirname(spec.origin), "backends",
                            "nvidia", "bin", "cuobjdump")
        if os.path.exists(path):
            return path
    fail("cuobjdump not found (CUDA toolkit or triton/backends/nvidia/bin)")


def sass_hgmma() -> None:
    """Count the HGMMA (wgmma) instructions in the SASS of each tensor-core
    kernel of the built library; fail if one has none."""
    sass = subprocess.run([_cuobjdump(), "--dump-sass",
                           str(build.library_path())], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and "HGMMA" in line:
            counts[cur] += 1
    names = [n for n in counts if any(k in n for k in WGMMA_KERNELS)]
    for kernel in WGMMA_KERNELS:
        if not any(kernel in n for n in names):
            fail(f"sass: no function named {kernel} in the library")
    for name, short in zip(names, map(_short, _demangle(names))):
        print(f"  SASS {short}: {counts[name]} HGMMA")
        if counts[name] == 0:
            fail(f"sass: {short} has no HGMMA instruction")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _decode_inputs(gen, B, H, Kv, D, C, dtype):
    return (randn(gen, (B, H, D), dtype), randn(gen, (B, C, Kv, D), dtype),
            randn(gen, (B, C, Kv, D), dtype))


def check_repeat(name: str, fn) -> None:
    """Two identical calls give the same bits (no atomics, a fixed
    combine order)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name}: two identical calls differ")
    print(f"  {name}: two identical calls bitwise equal")


def check_decode_controls(name: str, got, q, k, v, lengths) -> float:
    """Hold the kernels' bf16 output against plain versions that are off
    by one: every length one shorter and one longer (clamped to [0, C]),
    and chunk 1 (positions P..2P-1) read one position late. Every row
    that a control changes must fail DECODE_TOL in it, or the check could
    not see such a fault in that row. Returns the least of the rows'
    worst ratios."""
    tol = DECODE_TOL[torch.bfloat16]
    C = k.shape[1]
    P = dec_kernel.CHUNK
    lens = lengths.clamp(0, C)
    g = got.float()
    controls = {}
    for d in (-1, 1):
        lc = (lens + d).clamp(0, C)
        controls[f"length{d:+d}"] = (lc, k, v, lc != lens)
    ks, vs = k.clone(), v.clone()
    ks[:, P:2 * P] = k[:, P + 1:2 * P + 1]
    vs[:, P:2 * P] = v[:, P + 1:2 * P + 1]
    controls["chunk 1 one position late"] = (lens, ks, vs, lens > P)
    ratios = {}
    for label, (lc, kc, vc, rows) in controls.items():
        if not bool(rows.any()):
            continue
        w = decode_attention_ref(q, kc, vc, lc).float()
        per_row = ((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs())) \
            .flatten(1).amax(1)
        ratios[label] = float(per_row[rows].min())
    print(f"  {name} controls (least over the rows each changes): " +
          ", ".join(f"{label} {r:.1f}x the limit"
                    for label, r in ratios.items()))
    for label, r in ratios.items():
        if r <= 1:
            fail(f"{name}: the control {label} passes DECODE_TOL in a row: "
                 "the check cannot see that fault there")
    return min(ratios.values())


def decode_bound(lengths, B, H, Kv, D, C, dtype, pages: int = 0):
    """The card's least time for the call: q and out once, each live
    position's K and V row once, the lengths (and the table entries of
    the live pages)."""
    tokens = int(lengths.clamp(0, C).sum())
    es = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * H * D + 2 * tokens * Kv * D) * es + 4 * B + 4 * pages
    return bound_ms(nbytes, 4.0 * tokens * H * D, dtype)


def time_decode(label, q, k, v, lengths):
    """Events and device time of the kernels (split and combine apart),
    of the plain version and of F.scaled_dot_product_attention with the
    length mask (it reads all C positions of every row), the kernels' and
    SDPA's device time with a cold L2, and the device time of one sum
    over as many bytes as the live K/V rows, what this card reads in one
    kernel at this size."""
    B, H, D = q.shape
    C, Kv = k.shape[1], k.shape[2]
    kt = k.transpose(1, 2).repeat_interleave(H // Kv, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(H // Kv, dim=1).contiguous()
    mask = (torch.arange(C, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    def run():
        return decode_attention(q, k, v, lengths)

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None, :], kt, vt,
                                              attn_mask=mask)

    ms, dev = timed(run, "decode_attention_")
    split = device_ms(run, "decode_attention_split")
    combine = device_ms(run, "decode_attention_combine")
    plain, plain_dev = timed(lambda: decode_attention_ref(q, k, v, lengths))
    lib, lib_dev = timed(sdpa)
    # repeated calls find their K/V in the 50 MB L2; a decode step reads
    # each layer's cache once, so also time each call after a 64 MB write
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush_ms = device_ms(flush.zero_)
    cold = device_ms(lambda: (flush.zero_(), run()), "decode_attention_")
    lib_cold = device_ms(lambda: (flush.zero_(), sdpa())) - flush_ms
    b, by = decode_bound(lengths, B, H, Kv, D, C, q.dtype)
    # what the card reads at this size: one sum over the live K/V bytes
    live = torch.ones(int(lengths.clamp(0, C).sum()) * Kv * D * 2,
                      dtype=q.dtype, device="cuda")
    read = device_ms(lambda: live.sum(dtype=torch.float32))
    print(f"  {label}: kernels {ms:.4f} ms events, {dev:.4f} ms device "
          f"(split {split:.4f}, combine {combine:.4f}), {cold:.4f} ms device "
          f"with a cold L2; plain {plain:.3f} / {plain_dev:.4f} ms; "
          f"F.scaled_dot_product_attention {lib:.4f} / {lib_dev:.4f} ms, "
          f"{lib_cold:.4f} ms with a cold L2; bound {b:.4f} ms ({by}), the "
          f"kernels at {b / dev:.1%} of it ({b / cold:.1%} cold); a sum over "
          f"the live K/V bytes {read:.4f} ms device")
    return dict(ms=ms, device_ms=dev, split_device_ms=split,
                combine_device_ms=combine, cold_device_ms=cold,
                plain_ms=plain, plain_device_ms=plain_dev, library_ms=lib,
                library_device_ms=lib_dev, library_cold_device_ms=lib_cold,
                bound_ms=b, bound_by=by, live_sum_device_ms=read)


def check_decode(gen):
    """Both dtypes against the plain version at the timed shape (exact
    zeros for length 0, the same bits twice), rows at the chunk's edges,
    GQA g=6 at a C that is no chunk multiple, what the wrapper refuses,
    and the serve paths' shapes: 8 rows at ~300 positions (the decode
    profile's) and B=1 at 1024. Times at the timed and serve shapes."""
    print("[kernels] decode_attention")
    B, H, Kv, D, C = 8, 16, 16, 128, 1024
    P = dec_kernel.CHUNK
    lengths = torch.tensor([0, 1, C, 37, 500, 1000, 33, 613],
                           dtype=torch.int32, device="cuda")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _decode_inputs(gen, B, H, Kv, D, C, dtype)
        out = decode_attention(q, k, v, lengths)
        zero_rows = out[lengths == 0].float().abs().max()
        if float(zero_rows) != 0.0:
            fail("decode_attention: a length-0 row is not exactly zero")
        name = f"B={B} H={H} Kv={Kv} D={D} C={C} {dtype}"
        errs[dtype] = compare(name, out,
                              decode_attention_ref(q, k, v, lengths), dtype,
                              DECODE_TOL[dtype])
        if dtype == torch.bfloat16:
            check_decode_controls(name, out, q, k, v, lengths)
        check_repeat(f"B={B} C={C} {dtype}",
                     lambda: decode_attention(q, k, v, lengths))
    # the chunk's edges: P - 1, P, P + 1 (a chunk with one live position),
    # 2P + 1, C; g=4, C no multiple of P
    edge = torch.tensor([0, 1, P - 1, P, P + 1, 2 * P + 1, 1000],
                        dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _decode_inputs(gen, 7, 16, 4, D, 1000, dtype)
        name = f"lengths {edge.tolist()} g=4 C=1000 {dtype}"
        out = decode_attention(q, k, v, edge)
        compare(name, out, decode_attention_ref(q, k, v, edge), dtype,
                DECODE_TOL[dtype])
        if dtype == torch.bfloat16:
            check_decode_controls(name, out, q, k, v, edge)
    # GQA (qwen2-1.5b heads) and a cache length that is no chunk multiple
    lg = torch.tensor([600, 0, 17, 333], dtype=torch.int32, device="cuda")
    q, k, v = _decode_inputs(gen, 4, 12, 2, 128, 600, torch.float32)
    compare("GQA g=6 C=600 f32", decode_attention(q, k, v, lg),
            decode_attention_ref(q, k, v, lg), torch.float32,
            DECODE_TOL[torch.float32])
    # what the wrapper refuses: the 16-byte copies need D * elem % 16 == 0
    # and 16-byte-aligned K and V
    q, k, v = _decode_inputs(gen, 2, 4, 2, 12, 64, torch.bfloat16)
    kv_off = torch.empty(2 * 64 * 2 * 16 + 1, dtype=torch.bfloat16,
                         device="cuda")[1:].view(2, 64, 2, 16)
    q16 = randn(gen, (2, 4, 16), torch.bfloat16)
    for label, args in (("D=12 bf16", (q, k, v)),
                        ("K/V 2 bytes past an aligned address",
                         (q16, kv_off, kv_off))):
        try:
            decode_attention(*args, lg[:2].contiguous())
        except ValueError as e:
            print(f"  refuses {label}: {e}")
        else:
            fail(f"decode_attention: accepted {label}")

    dtype = torch.bfloat16
    q, k, v = _decode_inputs(gen, B, H, Kv, D, C, dtype)
    timing = time_decode(f"B={B} C={C} lengths {lengths.tolist()} bf16",
                         q, k, v, lengths)
    serve = {}
    rng = np.random.RandomState(5)
    for label, lens in (
            ("B=8 ~300 positions", rng.randint(290, 311, size=8)),
            ("B=1 1024 positions", np.array([1024]))):
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q, k, v = _decode_inputs(gen, len(lens), H, Kv, D, C, dtype)
        out = decode_attention(q, k, v, lt)
        compare(f"{label} C={C} bf16", out, decode_attention_ref(q, k, v, lt),
                dtype, DECODE_TOL[dtype])
        check_decode_controls(f"{label} C={C} bf16", out, q, k, v, lt)
        serve[label] = dict(time_decode(f"{label} C={C} bf16", q, k, v, lt),
                            lengths=lens.tolist())
    return dict(name="decode_attention", source=dec_kernel.SOURCE,
                replaces=dec_kernel.REPLACES, max_abs_err=errs[dtype],
                **timing, serve_shapes=serve,
                shape=f"B={B} H={H} Kv={Kv} D={D} C={C} lengths="
                      f"{lengths.tolist()} bf16")


def paged_layout(lengths, n_blocks: int, bs: int, pool: int, seed: int):
    """A block table for ``lengths``: each row's blocks are pages drawn
    without replacement from pages 1..pool-1 (page 0 is the reserved
    scratch page), -1 past the row's blocks."""
    order = list(np.random.RandomState(seed).permutation(
        np.arange(1, pool)))
    tbl = np.full((len(lengths), n_blocks), -1, np.int32)
    for b, n in enumerate(lengths):
        for c in range(-(-n // bs)):
            tbl[b, c] = order.pop()
    return torch.from_numpy(tbl).cuda()


def check_paged_equals_dense(label, q, kp, vp, lengths, tbl) -> float:
    """The paged kernels against their plain version (exact zeros for
    length 0), then bitwise against the dense kernels over the gathered
    contents. Returns the largest error."""
    out = decode_attention_paged(q, kp, vp, lengths, tbl)
    if float(out[lengths == 0].float().abs().max()) != 0.0:
        fail("decode_attention_paged: a length-0 row is not exactly zero")
    err = compare(label, out,
                  paged_decode_attention_ref(q, kp, vp, lengths, tbl),
                  q.dtype, DECODE_TOL[q.dtype])
    kd = gather_pages(kp, tbl).contiguous()
    vd = gather_pages(vp, tbl).contiguous()
    if q.dtype == torch.bfloat16:
        check_decode_controls(label, out, q, kd, vd, lengths)
    dense = decode_attention(q, kd, vd, lengths)
    torch.cuda.synchronize()
    if not torch.equal(out, dense):
        fail(f"decode_attention_paged {label}: not bitwise equal to the "
             "dense kernel on the gathered contents")
    print(f"  {label}: bitwise equal to the dense kernel on the gathered "
          "contents")
    return err


def check_decode_paged(gen):
    """Both dtypes against the plain version and bitwise against the
    dense kernels on the gathered contents and against themselves; page
    sizes below, at and above the chunk (one that does not divide it);
    GQA g=6 at bs=16; then the times beside the dense kernels' on the
    same contents."""
    print("[kernels] decode_attention_paged")
    B, H, Kv, D, bs, n_blocks, pool = 8, 16, 16, 128, 32, 32, 257
    P = dec_kernel.CHUNK
    lens_list = [0, 1, 1024, 37, 500, 1000, 33, 613]
    lengths = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    tbl = paged_layout(lens_list, n_blocks, bs, pool, seed=3)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = randn(gen, (B, H, D), dtype)
        kp = randn(gen, (pool, bs, Kv, D), dtype)
        vp = randn(gen, (pool, bs, Kv, D), dtype)
        errs[dtype] = check_paged_equals_dense(
            f"B={B} H={H} Kv={Kv} D={D} bs={bs} blocks={n_blocks} {dtype}",
            q, kp, vp, lengths, tbl)
        check_repeat(f"paged bs={bs} {dtype}",
                     lambda: decode_attention_paged(q, kp, vp, lengths, tbl))
    # page sizes against the chunk: below and dividing it, below and not
    # dividing it, equal, above; lengths at the chunk's edges
    edge = [0, 1, P - 1, P, P + 1, 2 * P + 1, 300]
    et = torch.tensor(edge, dtype=torch.int32, device="cuda")
    for pbs in (16, 48, P, 80):
        nb = -(-300 // pbs)
        pool_e = len(edge) * nb + 1
        tg = paged_layout(edge, nb, pbs, pool_e, seed=pbs)
        q = randn(gen, (len(edge), 8, D), torch.float32)
        kp = randn(gen, (pool_e, pbs, 2, D), torch.float32)
        vp = randn(gen, (pool_e, pbs, 2, D), torch.float32)
        check_paged_equals_dense(f"g=4 bs={pbs} lengths {edge} f32",
                                 q, kp, vp, et, tg)
    # GQA g=6 at a page size that is not the chunk
    lg = [600, 0, 17, 333]
    tg = paged_layout(lg, 38, 16, 65, seed=4)
    q = randn(gen, (4, 12, 128), torch.float32)
    kp = randn(gen, (65, 16, 2, 128), torch.float32)
    vp = randn(gen, (65, 16, 2, 128), torch.float32)
    lgt = torch.tensor(lg, dtype=torch.int32, device="cuda")
    check_paged_equals_dense("GQA g=6 bs=16 f32", q, kp, vp, lgt, tg)

    dtype = torch.bfloat16
    q = randn(gen, (B, H, D), dtype)
    kp = randn(gen, (pool, bs, Kv, D), dtype)
    vp = randn(gen, (pool, bs, Kv, D), dtype)
    kd = gather_pages(kp, tbl).contiguous()
    vd = gather_pages(vp, tbl).contiguous()
    def paged():
        return decode_attention_paged(q, kp, vp, lengths, tbl)

    def dense():
        return decode_attention(q, kd, vd, lengths)

    ms, dev = timed(paged, "decode_attention_")
    dense_ms, dense_dev = timed(dense, "decode_attention_")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cold = device_ms(lambda: (flush.zero_(), paged()), "decode_attention_")
    dense_cold = device_ms(lambda: (flush.zero_(), dense()),
                           "decode_attention_")
    plain, plain_dev = timed(
        lambda: paged_decode_attention_ref(q, kp, vp, lengths, tbl))
    pages = sum(-(-n // bs) for n in lens_list)
    b, by = decode_bound(lengths, B, H, Kv, D, n_blocks * bs, dtype, pages)
    print(f"  bf16: kernels {ms:.4f} ms events, {dev:.4f} ms device, "
          f"{cold:.4f} ms with a cold L2; the dense kernels on the same "
          f"contents {dense_ms:.4f} / {dense_dev:.4f} / {dense_cold:.4f} ms "
          f"(paged / dense device {dev / dense_dev:.3f}, cold "
          f"{cold / dense_cold:.3f}); plain {plain:.3f} / {plain_dev:.4f} "
          f"ms; bound {b:.4f} ms ({by})")
    return dict(name="decode_attention_paged", source=dec_kernel.SOURCE,
                replaces=dec_kernel.PAGED_REPLACES, max_abs_err=errs[dtype],
                ms=ms, device_ms=dev, cold_device_ms=cold, plain_ms=plain,
                plain_device_ms=plain_dev, bound_ms=b, bound_by=by,
                library_ms=None, dense_kernel_ms=dense_ms,
                dense_kernel_device_ms=dense_dev,
                dense_kernel_cold_device_ms=dense_cold,
                shape=f"B={B} H={H} Kv={Kv} D={D} bs={bs} blocks={n_blocks} "
                      f"pool={pool} lengths={lens_list} bf16")


# mLSTM: the summation order differs (matrix products per chunk, warp
# reductions, against the plain version's per-step einsum) over a
# recurrence of up to 600 steps; f32 throughout. m is compared bitwise.
MLSTM_TOL = dict(rtol=1e-4, atol=1e-4)


def mlstm_inputs(gen, B, H, S, D, fresh=False):
    """Random q/k/v/gates and a non-zero incoming state, or the state
    models/ssm.mlstm_state makes (C = n = 0, m = -1e30) with ``fresh``."""
    q = randn(gen, (B, H, S, D), torch.float32)
    k = randn(gen, (B, H, S, D), torch.float32, D ** -0.5)
    v = randn(gen, (B, H, S, D), torch.float32)
    ig = randn(gen, (B, H, S), torch.float32)
    lf = F.logsigmoid(randn(gen, (B, H, S), torch.float32) + 3.0)
    C0 = randn(gen, (B, H, D, D), torch.float32, 0.1)
    n0 = randn(gen, (B, H, D), torch.float32, 0.1)
    m0 = randn(gen, (B, H), torch.float32)
    if fresh:
        C0, n0, m0 = C0.zero_(), n0.zero_(), m0.fill_(-1e30)
    return q, k, v, ig, lf, C0, n0, m0


def mlstm_control_ref(q, k, v, ig, lf, C0, n0, m0, late_at=None,
                      peek=False, stale_m=False):
    """The plain recurrence with one slip, for the checks' controls:
    ``late_at`` — the carried state enters the chunk that starts at that
    step one step late (its first h sees only its own step's update);
    ``peek`` — the decay mask includes s = t + 1 within a chunk (h_t also
    sees step t + 1's v, weighted as the chunkwise form would);
    ``stale_m`` — the carried state's decay g_t is formed with m_{t-1}
    where m_t belongs (g_t exp(m_t - m_{t-1}) in place of g_t: an index
    slip by one step in the m track). Returns h."""
    L = mlstm_kernel.CHUNK
    C, n, m = C0, n0, m0
    hs = []
    S = q.shape[2]
    for t in range(S):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        if t % L == 0:
            Cc, nc, g = C, n, 1.0     # the carried state and its decay
        m_new = torch.maximum(lf[:, :, t] + m, ig[:, :, t])
        f_p = torch.exp(lf[:, :, t] + m - m_new)[..., None]
        i_p = torch.exp(ig[:, :, t] - m_new)[..., None]
        n = f_p * n + i_p * kt
        C = f_p[..., None] * C + (i_p * vt)[..., None] * kt[..., None, :]
        Cq = torch.einsum("bhvd,bhd->bhv", C, qt)
        nq = torch.einsum("bhd,bhd->bh", n, qt)
        g = g * f_p[..., 0]
        if stale_m:
            extra = (torch.exp(m_new - m) - 1.0) * g
            Cq = Cq + extra[..., None] * torch.einsum("bhvd,bhd->bhv", Cc,
                                                      qt)
            nq = nq + extra * torch.einsum("bhd,bhd->bh", nc, qt)
        if t == late_at:
            Cq = (i_p * vt) * torch.einsum("bhd,bhd->bh", kt, qt)[..., None]
            nq = i_p[..., 0] * torch.einsum("bhd,bhd->bh", kt, qt)
        if peek and (t + 1) % L != 0 and t + 1 < S:
            w = torch.exp(ig[:, :, t + 1] - lf[:, :, t + 1] - m_new)
            kq = torch.einsum("bhd,bhd->bh", k[:, :, t + 1], qt)
            Cq = Cq + (w * kq)[..., None] * v[:, :, t + 1]
            nq = nq + w * kq
        hs.append(Cq / torch.clamp(nq.abs(), min=1.0)[..., None])
        m = m_new
    return torch.stack(hs, dim=2)


def _mlstm_outs(fn, args):
    """Run one CUDA route of the mLSTM scan into fresh outputs."""
    q, C0, n0, m0 = args[0], args[5], args[6], args[7]
    h, C, n, m = (torch.empty_like(x) for x in (q, C0, n0, m0))
    if fn is mlstm_kernel.mlstm_scan_chunkwise_cuda:
        B, H, S, _ = q.shape
        rec = torch.empty(mlstm_kernel.record_numel(B * H, S),
                          device="cuda")
        fn(*args, rec, h, C, n, m)
    else:
        fn(*args, h, C, n, m)
    return h, C, n, m


def check_mlstm_against_plain(label, got, want) -> float:
    """h, C, n within MLSTM_TOL and m bitwise; returns the largest error."""
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in zip(("h", "C", "n", "m"), got, want):
        if g.shape != w.shape or g.dtype != torch.float32:
            fail(f"mlstm_scan {label} {name}: {tuple(g.shape)} {g.dtype}, "
                 f"plain {tuple(w.shape)} {w.dtype}")
        if not torch.isfinite(g).all():
            fail(f"mlstm_scan {label} {name}: non-finite kernel output")
        err = float((g - w).abs().max())
        worst = max(worst, err)
        if name == "m" and not torch.equal(g, w):
            fail(f"mlstm_scan {label}: m is not bitwise the plain version's")
        if not torch.allclose(g, w, **MLSTM_TOL):
            fail(f"mlstm_scan {label} {name}: max_abs_err {err:.3e} beyond "
                 f"rtol={MLSTM_TOL['rtol']} atol={MLSTM_TOL['atol']}")
    print(f"  {label}: h, C, n max_abs_err={worst:.3e} "
          f"(rtol={MLSTM_TOL['rtol']}, atol={MLSTM_TOL['atol']}), m bitwise "
          "equal")
    return worst


def check_mlstm_controls(label, h, args, want_h) -> float:
    """The kernel's h against plain versions with a chunkwise slip: the
    carried state entering chunk 1 one step late, the decay mask reaching
    s = t + 1, and the carried state's decay formed with m_{t-1} (a slip
    of a few percent in most rows). Every row (b, h, t) that a control
    moves beyond MLSTM_TOL (the plain version fails the limit against it
    there) must fail the limit against the kernel too, or the run fails.
    A row that a slip moves by less than the limit is one no check at
    this limit can see: those are counted and printed. Returns the least
    ratio over the rows each control moves beyond the limit."""
    L = mlstm_kernel.CHUNK
    tol = MLSTM_TOL

    def ratio(got, w):
        return ((got - w).abs() / (tol["atol"] + tol["rtol"] * w.abs())) \
            .amax(-1)

    least = {}
    for name, kw in (("state one step late at step L", dict(late_at=L)),
                     ("mask includes s = t+1", dict(peek=True)),
                     ("g_t with m_{t-1}", dict(stale_m=True))):
        w = mlstm_control_ref(*args, **kw)
        per_row = ratio(h, w)
        changed = (w != want_h).any(-1)
        seen = ratio(want_h, w) > 1
        if not bool(seen.any()):
            fail(f"mlstm_scan {label}: the control {name} moves no row "
                 "beyond the limit")
        least[name] = float(per_row[seen].min())
        print(f"  {label} control {name}: changes {int(changed.sum())} "
              f"rows, {int(seen.sum())} beyond the limit; there the kernel "
              f"fails it by at least {least[name]:.2f}x (median "
              f"{float(per_row[seen].median()):.1f}x); least over every "
              f"row it changes {float(per_row[changed].min()):.2f}x")
        if least[name] <= 1:
            fail(f"mlstm_scan {label}: the control {name} passes MLSTM_TOL "
                 "in a row it moves beyond the limit")
    return min(least.values())


def check_mlstm(gen):
    """Both routes against the plain version: the wrapper's choice at each
    S (chunkwise from CHUNKWISE_MIN_S on, recurrent below), the chunk's
    edges, a fresh and a non-zero state, and each route forced at a shape
    the wrapper sends to the other; controls that the chunkwise form must
    fail; device times warm and with a cold L2 at S=600 and S=64 (B=1) and
    S=1 (B=8)."""
    print("[kernels] mlstm_scan")
    H, D, L = 4, 1024, mlstm_kernel.CHUNK
    errs, timing = {}, {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush_ms = device_ms(flush.zero_)
    for B, S, fresh in ((1, 600, False), (1, 600, True), (1, 64, False),
                        (1, 37, False), (1, L - 1, False), (1, L, True),
                        (1, L + 1, False), (1, 2 * L + 3, False),
                        (8, 1, False), (8, 1, True)):
        args = mlstm_inputs(gen, B, H, S, D, fresh)
        want = mlstm_scan_ref(*args)
        label = (f"B={B} H={H} S={S} D={D} {mlstm_ops.route(S)}, "
                 f"{'fresh' if fresh else 'non-zero'} state")
        got = mlstm_scan(*args)
        errs[(B, S, fresh)] = check_mlstm_against_plain(label, got, want)
        other = (mlstm_kernel.mlstm_scan_cuda
                 if mlstm_ops.route(S) == "chunkwise"
                 else mlstm_kernel.mlstm_scan_chunkwise_cuda)
        if S in (37, 1) and not fresh:
            check_mlstm_against_plain(
                label.replace(mlstm_ops.route(S), f"{other.__name__} forced"),
                _mlstm_outs(other, args), want)
        if S == 600 and not fresh:
            control = check_mlstm_controls(label, got[0], args, want[0])
        if S in (600, 64, 1) and not fresh:
            def run():
                return mlstm_scan(*args)
            # the chunkwise route launches a prep and a scan kernel
            n_k = 2 if mlstm_ops.route(S) == "chunkwise" else 1
            ms, dev = timed(run, "mlstm_", per_call=n_k)
            cold = device_ms(lambda: (flush.zero_(), run()), "mlstm_",
                             per_call=n_k)
            split = ({k: device_ms(run, k) for k in ("mlstm_chunk_prep",
                                                     "mlstm_chunk_scan")}
                     if mlstm_ops.route(S) == "chunkwise" else {})
            plain = time_ms(lambda: mlstm_scan_ref(*args), iters=3, warmup=1)
            nbytes = 4 * (4 * B * H * S * D + 2 * B * H * S
                          + 2 * B * H * D * D + 2 * B * H * D + 2 * B * H)
            flops = 4.0 * D * D * S * H * B
            b, by = bound_ms(nbytes, flops, torch.float32)
            timing[(B, S)] = dict(ms=ms, device_ms=dev, cold_device_ms=cold,
                                  plain_ms=plain, bound_ms=b, bound_by=by,
                                  route=mlstm_ops.route(S),
                                  **{f"{k}_device_ms": v
                                     for k, v in split.items()})
            print(f"  B={B} S={S} ({mlstm_ops.route(S)}): {ms:.4f} ms "
                  f"events, {dev:.4f} ms device, {cold:.4f} ms device with "
                  f"a cold L2 (a 64 MB write between calls, itself "
                  f"{flush_ms:.4f} ms, not counted); " +
                  "".join(f"{k} {v:.4f} ms; " for k, v in split.items()) +
                  f"plain {plain:.3f} ms; bound {b:.4f} ms ({by}), the "
                  f"kernels at {b / dev:.1%} of it")
        del args, got, want
        torch.cuda.empty_cache()
    t = timing[(1, 600)]
    return dict(name="mlstm_scan", source=mlstm_kernel.SOURCE,
                replaces=mlstm_kernel.REPLACES,
                max_abs_err=errs[(1, 600, False)], library_ms=None, **t,
                control_worst_ratio=control,
                s64=dict(timing[(1, 64)], shape="B=1 H=4 S=64 D=1024 f32"),
                decode=dict(timing[(8, 1)], shape="B=8 H=4 S=1 D=1024 f32"),
                shape=f"B=1 H={H} S=600 D={D} f32")


def check_moe_gemm_controls(name: str, got, x, wg, wu, wd, want) -> float:
    """Hold the kernel's bf16 output against plain versions with one slip
    each: the gate and up products without their first 16-wide slice of
    M (one k16 step of wgmma), the down product without its last 64-deep
    tile of H, expert 0 with expert 1's weights. Every row (e, c) that a
    control changes must fail GEMM_TOL in it, or the check could not see
    such a fault in that row. Returns the least of the rows' worst
    ratios."""
    tol = GEMM_TOL[torch.bfloat16]
    g = got.float()
    xd = x.clone()
    xd[..., :16] = 0
    wdd = wd.clone()
    wdd[:, -64:] = 0
    swap = [w.clone() for w in (wg, wu, wd)]
    for w, orig in zip(swap, (wg, wu, wd)):
        w[0] = orig[1]
    controls = {"gate/up M[0:16] dropped": (xd, wg, wu, wd),
                "down H cut by one tile": (x, wg, wu, wdd),
                "expert 0 with expert 1's weights": (x, *swap)}
    ratios = {}
    for label, args in controls.items():
        w = moe_gemm_ref(*args)
        rows = (w != want).any(-1)
        wf = w.float()
        per_row = ((g - wf).abs() / (tol["atol"] + tol["rtol"] * wf.abs())) \
            .amax(-1)
        if not bool(rows.any()):
            fail(f"{name}: the control {label} changes no row")
        ratios[label] = float(per_row[rows].min())
        del w, wf, per_row
    print(f"  {name} controls (least over the rows each changes): " +
          ", ".join(f"{label} {r:.1f}x the limit"
                    for label, r in ratios.items()))
    for label, r in ratios.items():
        if r <= 1:
            fail(f"{name}: the control {label} passes GEMM_TOL in a row: "
                 "the check cannot see that fault there")
    return min(ratios.values())


def check_moe_gemm(gen):
    """Every capacity through the wrapper in f32 and bf16 against the plain
    version (bf16 at GEMM_TOL, beside controls at C=1 and C=683); the bf16
    kernel's device time at each decode-sized C (where it should stay at
    the weights' bytes bound), and the serving path's two regimes timed:
    C=683 (8192 prefill tokens) and C=1 (decode)."""
    print("[kernels] moe_gemm")
    E, M, H = 60, 2048, 1408
    errs, timing, small, controls = {}, {}, {}, {}
    for C in (1, 2, 4, 8, 37, 683):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(gen, (E, C, M), dtype)
            wg = randn(gen, (E, M, H), dtype, M ** -0.5)
            wu = randn(gen, (E, M, H), dtype, M ** -0.5)
            wd = randn(gen, (E, H, M), dtype, H ** -0.5)
            want = moe_gemm_ref(x, wg, wu, wd)
            name = f"E={E} C={C} M={M} H={H} {dtype}"
            got = moe_gemm(x, wg, wu, wd)
            errs[(C, dtype)] = compare(name, got, want, dtype,
                                       GEMM_TOL[dtype])
            if dtype == torch.bfloat16 and C in (1, 683):
                controls[C] = check_moe_gemm_controls(name, got, x, wg, wu,
                                                      wd, want)
            del got
            if dtype == torch.bfloat16 and C <= 8:
                small[C] = device_ms(lambda: moe_gemm(x, wg, wu, wd),
                                     "moe_gemm_")
                print(f"  C={C} bf16: {small[C]:.4f} ms on the device")
            if dtype == torch.bfloat16 and C in (1, 683):
                ms, dev = timed(lambda: moe_gemm(x, wg, wu, wd), "moe_gemm_")
                plain, plain_dev = timed(
                    lambda: moe_gemm_ref(x, wg, wu, wd), iters=5)
                lib, lib_dev = timed(lambda: torch.bmm(
                    F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd))
                flops = 6.0 * E * C * M * H
                nbytes = (2 * E * C * M + 3 * E * M * H) * 2
                b, by = bound_ms(nbytes, flops, dtype)
                timing[C] = dict(
                    ms=ms, device_ms=dev, plain_ms=plain,
                    plain_device_ms=plain_dev, library_ms=lib,
                    library_device_ms=lib_dev, bound_ms=b, bound_by=by,
                    tflops=flops / dev / 1e9, tbps=nbytes / dev / 1e9)
                print(f"  C={C} bf16: kernel {ms:.3f} ms events, "
                      f"{dev:.4f} ms device ({flops / dev / 1e9:.1f} TFLOP/s"
                      f", {nbytes / dev / 1e9:.3f} TB/s); plain {plain:.3f} /"
                      f" {plain_dev:.3f} ms; torch.bmm x3 {lib:.3f} / "
                      f"{lib_dev:.4f} ms; bound {b:.3f} ms ({by})")
            del x, wg, wu, wd, want
            torch.cuda.empty_cache()
    return dict(name="moe_gemm", source=gemm_kernel.SOURCE,
                replaces=gemm_kernel.REPLACES,
                max_abs_err=errs[(683, torch.bfloat16)], **timing[683],
                shape=f"E={E} C=683 M={M} H={H} bf16",
                decode=dict(timing[1], shape=f"E={E} C=1 M={M} H={H} bf16"),
                small_c_device_ms={f"C={c}": v for c, v in small.items()},
                control_worst_ratio={f"C={c}": v
                                     for c, v in controls.items()})


def check_flash_controls(name: str, got, q, k, v, window=None) -> float:
    """Hold the kernel's bf16 output against plain versions whose mask is
    off by one: every query one position later (the causal diagonal and
    the window's start shifted), and the window one key shorter and
    longer. Each must fail FLASH_TOL, or the check could not see such a
    fault. Returns the least of their worst ratios."""
    tol = FLASH_TOL[torch.bfloat16]
    g = got.float()
    shifted = flash_attention_ref(torch.roll(q, 1, dims=1), k, v,
                                  window=window)
    wrongs = {"position+1": (g[:, :-1], shifted[:, 1:])}
    if window is not None:
        for d in (-1, 1):
            wrongs[f"window{d:+d}"] = (
                g, flash_attention_ref(q, k, v, window=window + d))
    ratios = {label: _worst(a, b.float(), tol)
              for label, (a, b) in wrongs.items()}
    print(f"  {name} controls: " + ", ".join(
        f"{label} {r:.1f}x the limit" for label, r in ratios.items()))
    for label, r in ratios.items():
        if r <= 1:
            fail(f"{name}: the control {label} passes FLASH_TOL: the check "
                 "cannot see a mask off by one")
    return min(ratios.values())


def check_flash_head_dims(gen, window=None):
    """Every head dim the kernel takes, in bf16, at a small S and at a
    ragged S (GQA, then MQA), with or without a window."""
    for D in flash_kernel.HEAD_DIMS:
        for B, S, H, Kv in ((2, 128, 4, 2), (1, 333, 6, 1)):
            q = randn(gen, (B, S, H, D), torch.bfloat16)
            k = randn(gen, (B, S, Kv, D), torch.bfloat16)
            v = randn(gen, (B, S, Kv, D), torch.bfloat16)
            name = f"B={B} S={S} H={H} Kv={Kv} D={D} window={window} bf16"
            got = flash_attention(q, k, v, window=window)
            compare(name, got, flash_attention_ref(q, k, v, window=window),
                    torch.bfloat16, FLASH_TOL[torch.bfloat16])
            check_flash_controls(name, got, q, k, v, window)


def check_flash(gen):
    print("[kernels] flash_attention")
    H, Kv, D = 16, 16, 128
    errs = {}
    timing = None
    for B, S in ((8, 64), (2, 1024), (2, 600)):
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, S, H, D), dtype)
            k = randn(gen, (B, S, Kv, D), dtype)
            v = randn(gen, (B, S, Kv, D), dtype)
            name = f"B={B} S={S} H={H} Kv={Kv} D={D} {dtype}"
            got = flash_attention(q, k, v)
            errs[(S, dtype)] = compare(name, got,
                                       flash_attention_ref(q, k, v), dtype,
                                       FLASH_TOL[dtype])
            if dtype == torch.bfloat16:
                check_flash_controls(name, got, q, k, v)
            if S == 1024 and dtype == torch.bfloat16:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                ms, dev = timed(lambda: flash_attention(q, k, v),
                                "flash_attention_")
                plain, plain_dev = timed(lambda: flash_attention_ref(q, k, v))
                lib, lib_dev = timed(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
                flops = 4.0 * B * H * D * S * (S + 1) / 2
                nbytes = (2 * B * S * H * D + 2 * B * S * Kv * D) * 2
                b, by = bound_ms(nbytes, flops, dtype)
                timing = dict(ms=ms, device_ms=dev, plain_ms=plain,
                              plain_device_ms=plain_dev, library_ms=lib,
                              library_device_ms=lib_dev, bound_ms=b,
                              bound_by=by, tflops=flops / dev / 1e9)
                print(f"  B={B} S={S} bf16: kernel {ms:.4f} ms events, "
                      f"{dev:.4f} ms device ({flops / dev / 1e9:.1f} "
                      f"TFLOP/s); plain {plain:.3f} / {plain_dev:.3f} ms; "
                      f"F.scaled_dot_product_attention {lib:.4f} / "
                      f"{lib_dev:.4f} ms; bound {b:.4f} ms ({by})")
    # GQA with a sliding window (the kernel's window bound), ragged S
    q = randn(gen, (1, 600, 12, 128), torch.float32)
    k = randn(gen, (1, 600, 2, 128), torch.float32)
    v = randn(gen, (1, 600, 2, 128), torch.float32)
    compare("GQA g=6 S=600 window=128 f32",
            flash_attention(q, k, v, window=128),
            flash_attention_ref(q, k, v, window=128), torch.float32,
            FLASH_TOL[torch.float32])
    del q, k, v
    check_flash_head_dims(gen)
    hybrid = check_flash_local(gen)
    return dict(name="flash_attention", source=flash_kernel.SOURCE,
                replaces=flash_kernel.REPLACES,
                max_abs_err=errs[(1024, torch.bfloat16)], **timing,
                shape=f"B=2 S=1024 H={H} Kv={Kv} D={D} causal bf16",
                hybrid=hybrid)


def check_flash_local(gen):
    """The hybrid path's local-attention prefill: MQA at D=256 with a
    2048-key window, at a prompt longer than the window; then every head
    dim with a window that the small and ragged S exceed."""
    B, S, H, Kv, D, win = 1, 3000, 16, 1, 256, 2048
    shape = f"B={B} S={S} H={H} Kv={Kv} D={D} window={win}"
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = randn(gen, (B, S, H, D), dtype)
        k = randn(gen, (B, S, Kv, D), dtype)
        v = randn(gen, (B, S, Kv, D), dtype)
        got = flash_attention(q, k, v, window=win)
        errs[dtype] = compare(f"{shape} {dtype}", got,
                              flash_attention_ref(q, k, v, window=win),
                              dtype, FLASH_TOL[dtype])
        if dtype == torch.bfloat16:
            control = check_flash_controls(f"{shape} {dtype}", got, q, k, v,
                                           win)
        del q, k, v, got
        torch.cuda.empty_cache()
    check_flash_head_dims(gen, window=100)
    dtype = torch.bfloat16
    q = randn(gen, (B, S, H, D), dtype)
    k = randn(gen, (B, S, Kv, D), dtype)
    v = randn(gen, (B, S, Kv, D), dtype)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).expand(B, H, S, D).contiguous()
    vt = v.transpose(1, 2).expand(B, H, S, D).contiguous()
    pos = torch.arange(S, device="cuda")
    diff = pos[:, None] - pos[None, :]
    mask = (diff >= 0) & (diff < win)
    ms, dev = timed(lambda: flash_attention(q, k, v, window=win),
                    "flash_attention_")
    plain, plain_dev = timed(
        lambda: flash_attention_ref(q, k, v, window=win), iters=3)
    lib, lib_dev = timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    pairs = int(mask.sum())
    flops = 4.0 * B * H * D * pairs
    nbytes = (2 * B * S * H * D + 2 * B * S * Kv * D) * 2
    b, by = bound_ms(nbytes, flops, dtype)
    print(f"  {shape} bf16: kernel {ms:.3f} ms events, {dev:.4f} ms device "
          f"({flops / dev / 1e9:.1f} TFLOP/s); plain {plain:.3f} / "
          f"{plain_dev:.3f} ms; F.scaled_dot_product_attention (window "
          f"mask) {lib:.3f} / {lib_dev:.4f} ms; bound {b:.4f} ms ({by})")
    return dict(ms=ms, device_ms=dev, plain_ms=plain,
                plain_device_ms=plain_dev, library_ms=lib,
                library_device_ms=lib_dev, bound_ms=b, bound_by=by,
                tflops=flops / dev / 1e9, max_abs_err=errs[dtype],
                max_abs_err_f32=errs[torch.float32],
                control_worst_ratio=control, shape=f"{shape} bf16")


# RG-LRU: the kernel's step rounds as the plain version's separate
# multiply and add do, so f32 must be bitwise equal (a failing check);
# bf16 inputs are held to the reference's kernel tolerance
# (tests/test_kernels.py:86-89)
RGLRU_TOL = dict(rtol=1e-5, atol=1e-5)


def check_rg_lru(gen):
    """f32 bitwise and bf16 within RGLRU_TOL at decode (B=8, S=1, the short
    kernel), the hybrid prefill shapes (B=1, W=4096, S=600 and S=3000), a
    ragged one (3, 37, 1000), a short prompt (2, 20, 1000: the short
    kernel, S not a multiple of its unroll) and two that fill only part of
    the tile kernel's ring (one and two tiles, the last one partial); f32
    device times warm and with a cold L2 (a 64 MB write between calls: a
    3000-token prefill moves three times the L2) at the first three."""
    print("[kernels] rg_lru_scan")
    errs, timing = {}, {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush_ms = device_ms(flush.zero_)
    for B, S, W in ((8, 1, 4096), (1, 600, 4096), (1, 3000, 4096),
                    (3, 37, 1000), (2, 20, 1000), (1, 100, 4096),
                    (2, 200, 1000)):
        for dtype in (torch.float32, torch.bfloat16):
            a = (0.8 + 0.199 * torch.rand((B, S, W), generator=gen,
                                          device="cuda")).to(dtype)
            b = randn(gen, (B, S, W), dtype, 0.1)
            h0 = randn(gen, (B, W), torch.float32)
            got = rg_lru_scan(a, b, h0)
            want = rg_lru_scan_ref(a, b, h0)
            torch.cuda.synchronize()
            err, same = 0.0, True
            for name, g, w in zip(("h", "h_last"), got, want):
                if g.shape != w.shape or g.dtype != torch.float32:
                    fail(f"rg_lru_scan {name}: {tuple(g.shape)} {g.dtype}, "
                         f"plain {tuple(w.shape)} {w.dtype}")
                if not torch.isfinite(g).all():
                    fail(f"rg_lru_scan {name}: non-finite kernel output")
                err = max(err, float((g - w).abs().max()))
                same = same and torch.equal(g, w)
                if not torch.allclose(g, w, **RGLRU_TOL):
                    fail(f"rg_lru_scan B={B} S={S} W={W} {dtype} {name}: "
                         f"max_abs_err {err:.3e}")
            if dtype == torch.float32 and not same:
                fail(f"rg_lru_scan B={B} S={S} W={W} f32: not bitwise equal "
                     f"to the plain version (max_abs_err {err:.3e})")
            errs[(B, S, dtype)] = err
            print(f"  B={B} S={S} W={W} {dtype}, non-zero h0: h, h_last "
                  f"max_abs_err={err:.3e} (rtol={RGLRU_TOL['rtol']}, "
                  f"atol={RGLRU_TOL['atol']}) "
                  f"{'bitwise equal' if same else 'ok, not bitwise'}")
            if dtype == torch.float32 and (B, S) in ((8, 1), (1, 600),
                                                     (1, 3000)):
                def run():
                    return rg_lru_scan(a, b, h0)
                ms, dev = timed(run, "rg_lru_scan")
                cold = device_ms(lambda: (flush.zero_(), run()),
                                 "rg_lru_scan")
                plain = time_ms(lambda: rg_lru_scan_ref(a, b, h0),
                                iters=3, warmup=1)
                nbytes = 4 * (3 * B * S * W + 2 * B * W)
                b_ms, by = bound_ms(nbytes, 2.0 * B * S * W, torch.float32)
                timing[(B, S)] = dict(ms=ms, device_ms=dev,
                                      cold_device_ms=cold, plain_ms=plain,
                                      bound_ms=b_ms, bound_by=by)
                print(f"  B={B} S={S} W={W} f32: kernel {ms:.4f} ms (CUDA "
                      f"events, with the wrapper's host path), {dev:.5f} ms "
                      f"on the device, {cold:.5f} ms with a cold L2 (the "
                      f"64 MB write, {flush_ms:.4f} ms, not counted); plain "
                      f"{plain:.3f} ms, bound {b_ms:.5f} ms ({by}), the "
                      f"kernel at {b_ms / cold:.1%} of it cold")
            del a, b, h0, got, want
            torch.cuda.empty_cache()
    print("  f32 bitwise equal to the plain version at every shape")
    return dict(name="rg_lru_scan", source=rglru_kernel.SOURCE,
                replaces=rglru_kernel.REPLACES,
                max_abs_err=errs[(1, 3000, torch.float32)], library_ms=None,
                bitwise_f32=True, **timing[(1, 3000)],
                s600=dict(timing[(1, 600)], shape="B=1 S=600 W=4096 f32"),
                decode=dict(timing[(8, 1)], shape="B=8 S=1 W=4096 f32"),
                shape="B=1 S=3000 W=4096 f32")


# ---------------------------------------------------------------------------
# phase 3: a small model on the card against the same model on the CPU
# ---------------------------------------------------------------------------

def phase_small() -> None:
    for arch in ("qwen2-moe-a2.7b", "qwen2-1.5b", "xlstm-1.3b",
                 "recurrentgemma-9b"):
        cfg = get_smoke_config(arch)
        ctx = ExecutionContext(attn_impl="decode_kernel")
        cpu = build_model(cfg, ctx=ctx, dtype=torch.float32, device="cpu")
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        p_cpu = cpu.init(gen)
        gpu = build_model(cfg, ctx=ctx, dtype=torch.float32, device="cuda")
        p_gpu = params_from_numpy(_to_numpy(p_cpu), "cuda", torch.float32)
        rng = np.random.RandomState(0)
        # a recurrent state would carry the padding of shorter rows; the
        # hybrid prompt is longer than its 64-token window, so its ring
        # rolls at prefill and decodes past the wrap
        lens, budget = {"ssm": ([16] * 3, 32),
                        "hybrid": ([80] * 3, 128)}.get(cfg.family,
                                                       ([5, 9, 13], 32))
        toks = np.zeros((3, max(16, max(lens))), np.int64)
        for i, n in enumerate(lens):
            toks[i, :n] = rng.randint(0, cfg.vocab_size, size=n)
        last = torch.tensor([n - 1 for n in lens])
        worst = 0.0
        outs = {}
        for name, model, params in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
            logits, caches = model.prefill(params, torch.from_numpy(toks),
                                           seq_budget=budget,
                                           last_positions=last)
            for c in caches:
                if "index" in c:
                    c["index"] = torch.tensor(lens, dtype=torch.int32,
                                              device=model.device)
            seq = [logits[:, -1].float().cpu()]
            lengths = torch.tensor(lens, dtype=torch.int32) + 1
            for _ in range(4):
                nxt = seq[-1].argmax(-1)[:, None]
                logits, caches = model.decode_step(params, nxt, caches,
                                                   lengths=lengths)
                seq.append(logits[:, -1].float().cpu())
                lengths = lengths + 1
            outs[name] = seq
        for a, b in zip(outs["cpu"], outs["gpu"]):
            worst = max(worst, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                fail(f"{arch} smoke: card logits disagree with the CPU")
            if not torch.equal(a.argmax(-1), b.argmax(-1)):
                fail(f"{arch} smoke: greedy tokens disagree with the CPU")
        print(f"[small] {cfg.name}: prefill + 4 decode steps on the card "
              f"match the CPU (max |dlogit| {worst:.2e}, rtol=atol=1e-4), "
              "greedy tokens equal")
    small_paged()


def small_paged() -> None:
    """A paged engine (page size 16, GQA g=2) on the card against the same
    engine on the CPU: equal greedy tokens on a shared-prefix trace."""
    cfg = get_smoke_config("qwen2-1.5b")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    p_cpu = build_model(cfg, dtype=torch.float32, device="cpu").init(gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        params = (p_cpu if dev == "cpu" else
                  params_from_numpy(_to_numpy(p_cpu), "cuda", torch.float32))
        eng = ServingEngine(cfg, params=params, num_slots=3, max_context=64,
                            kv_layout="paged", kv_block_size=16,
                            dtype=torch.float32, device=dev)
        rng = np.random.RandomState(2)
        shared = list(rng.randint(0, cfg.vocab_size, size=20))
        reqs = [Request(prompt=shared + list(rng.randint(
            0, cfg.vocab_size, size=n)), max_new_tokens=6)
            for n in (3, 9, 12, 1)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        eng.kv.check_invariants()
        outs[dev] = [r.output for r in reqs]
        hits = eng.paging_stats()["prefix_hit_tokens"]
    if outs["cpu"] != outs["cuda"]:
        fail(f"paged smoke engine: card tokens {outs['cuda']} differ from "
             f"the CPU's {outs['cpu']}")
    print(f"[small] {cfg.name} paged engine (bs=16, {hits} prefix-hit "
          "tokens): greedy tokens on the card equal the CPU's")


def phase_ring() -> None:
    """Teacher-forced decode against prefill at full width across the
    local-attention ring's wrap: recurrentgemma-9b cut to one (rec, rec,
    attn) group, f32 weights drawn on the card. Prefill 2040 tokens, then
    decode 12 more one at a time (positions 2040..2051, so the 2048-slot
    ring wraps at 2048); each step's logits must equal the last logits of
    a prefill of the whole prompt so far, whose prefill at S > 2048 takes
    the roll. The ring and the RG-LRU states after the 12 steps must equal
    those of the 2052-token prefill."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=3)
    atol = 1e-3   # f32 through 3 layers at S ~ 2050, summation order only
    t0 = time.perf_counter()
    model = build_model(cfg, ctx=ExecutionContext(attn_impl="decode_kernel"),
                        dtype=torch.float32, device="cuda")
    params = model.init(generator_for(model.device, 0))
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(1, 2060))).cuda()
    _, caches = model.prefill(params, toks[:, :2040], seq_budget=4096)
    worst = 0.0
    for j in range(12):
        logits, caches = model.decode_step(params, toks[:, 2040 + j:2041 + j],
                                           caches)
        want, pre = model.prefill(params, toks[:, :2041 + j],
                                  seq_budget=4096)
        if not torch.isfinite(logits).all():
            fail(f"ring: non-finite logits at decode step {j}")
        err = float((logits - want).abs().max())
        worst = max(worst, err)
        if err > atol:
            fail(f"ring: decode step {j} (position {2040 + j}) logits differ "
                 f"from prefill by {err:.3e} > {atol}")
    state_err = 0.0
    for i, kind in enumerate(model.kinds):
        for name in (("k", "v") if kind == "attn" else ("h", "conv")):
            state_err = max(state_err, float(
                (caches[i][name] - pre[i][name]).abs().max()))
        if kind == "attn" and int(caches[i]["index"]) != 2052:
            fail(f"ring: cache index {int(caches[i]['index'])} != 2052")
    if state_err > atol:
        fail(f"ring: decoded ring/state differs from the rolled prefill's by "
             f"{state_err:.3e} > {atol}")
    print(f"[ring] {cfg.name} at full width, {model.kinds}, f32: 12 decode "
          f"steps across the 2048-slot ring's wrap match prefill (max "
          f"|dlogit| {worst:.2e}, atol={atol}); ring and states after the "
          f"steps match the rolled 2052-token prefill (max diff "
          f"{state_err:.2e}); {time.perf_counter() - t0:.1f} s")
    del model, params, caches, pre
    torch.cuda.empty_cache()


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


# ---------------------------------------------------------------------------
# phase 4a: calibrate the cost model on the card
# ---------------------------------------------------------------------------

#: where and at what dtype the calibrate phase measures (the engine's
#: serving dtype; the CPU rehearsal takes the CPU at f32)
CAL_DEVICE = "cuda"
CAL_DTYPE = torch.bfloat16
#: the R^2 every non-proxy fit must reach (the reference's ``min_r2``)
CAL_MIN_R2 = 0.9
#: the card's peak rate per unit of each primitive's x: GEMM and
#: attention in FLOP (2 per m·k·n; 2 per unit of N_h·B·S^2·(d_k+d_v) for
#: the full square, of which a causal kernel does half), decode in bytes
#: read, the copy proxy in bytes read and written (2 per byte)
CAL_PEAK = {"gemm": (2, PEAK_FLOPS[torch.bfloat16], "FLOP/s"),
            "attn": (2, PEAK_FLOPS[torch.bfloat16], "FLOP/s (full S^2)"),
            "decode": (1, HBM_BYTES_PER_S, "B/s"),
            "comm": (2, HBM_BYTES_PER_S, "B/s")}


def sweep_calls(sweep, retries: int) -> int:
    """Kernel calls of a sweep: warm-up and timed calls per sample (the
    full sweep's 2 + 9), once and again per retry."""
    return len(sweep) * (2 + 9) * (1 + retries)


def phase_calibrate(store_dir: str):
    """``calibrate()`` on the card at bf16 over the card's sweeps (full:
    2 warm-up and 9 timed calls per sample), into a fresh store. Prints
    each primitive's samples, fit, proxy flag, retries and implied rate;
    fails on a non-proxy fit with R^2 under ``CAL_MIN_R2`` or beta <= 0,
    on flash or decode-attention launches other than the sweeps' calls,
    and unless the stored profile loads back bit for bit. Returns the
    fitted profile."""
    device = torch.device(CAL_DEVICE)
    key = ProfileKey.for_host(None, CAL_DTYPE, device)
    kernel_lib.reset_launch_counts()
    res = calibrate(name=key.slug(), fast=False, dtype=CAL_DTYPE,
                    device=device, min_r2=CAL_MIN_R2)
    counts = kernel_lib.launch_counts()
    hw = res.profile
    print(f"[calibrate] {key.device_kind}, {CAL_DTYPE}: {res.wall_s:.2f} s "
          f"wall; profile {hw.name!r}")
    for kind, s in res.samples.items():
        fit = getattr(hw, kind)
        mult, peak, unit = CAL_PEAK[kind]
        rate = mult / fit.beta if fit.beta > 0 else float("nan")
        note = (" (proxy: an on-card copy, one card has no wire; plans "
                "on it see transport as nearly free)" if kind == "comm"
                and s.proxy else " (proxy)" if s.proxy else "")
        print(f"[calibrate] {kind}: alpha {fit.alpha:.6e} s, beta "
              f"{fit.beta:.6e} s/unit, R^2 {res.fit_r2[kind]:.6f}, proxy "
              f"{s.proxy}, retries {res.retries[kind]}; beta implies "
              f"{rate:.4e} {unit} against the card's peak {peak:.4e} "
              f"({rate / peak:.1%}){note}")
        print(f"[calibrate] {kind} samples (x, median ms): " + json.dumps(
            [[x, t * 1e3] for x, t in zip(s.xs, s.ts)]))
        if not s.proxy and res.fit_r2[kind] < CAL_MIN_R2:
            fail(f"calibrate: {kind} fits with R^2 {res.fit_r2[kind]:.4f} "
                 f"< {CAL_MIN_R2}")
        if not s.proxy and fit.beta <= 0:
            fail(f"calibrate: {kind} beta {fit.beta:.3e} <= 0")
    sweeps = sweeps_for(device, fast=False)
    # the CPU rehearsal times the plain versions, which count no launch
    on_card = device.type == "cuda"
    want = {"flash_attention": sweep_calls(
                sweeps.attn, res.retries["attn"]) * on_card,
            "decode_attention": sweep_calls(
                sweeps.decode, res.retries["decode"]) * on_card}
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"calibrate: {name} launched {n} times, the sweeps call it "
                 f"{want.get(name, 0)} times")
    store = ProfileStore(store_dir)
    stored = store.put_calibration(res, key)
    back = store.get(stored.name)
    if (back.profile != hw or back.profile.as_dict() != hw.as_dict()
            or back.fit_r2 != res.fit_r2 or back.key != key
            or back.comm_proxy != res.comm_is_proxy
            or back.samples != {k: v.as_xt()
                                for k, v in res.samples.items()}):
        fail("calibrate: the stored profile does not load back bit for bit")
    print(f"[calibrate] launches {counts}; stored as {stored.name!r} and "
          "loaded back bit for bit; " + json.dumps(dict(
              key=key.as_dict(), profile=hw.as_dict(), fit_r2=res.fit_r2,
              retries=res.retries, wall_s=res.wall_s,
              comm_proxy=res.comm_is_proxy, launches=counts)))
    return hw, counts


# ---------------------------------------------------------------------------
# phase 4: serve the full-width models, one path at a time
# ---------------------------------------------------------------------------

def mixed_requests(cfg, seed: int = 0):
    """16 requests with prompts of 16-600 tokens and 32 new tokens, even
    ones greedy and odd ones at temperature 0.8."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(16):
        n = int(rng.randint(16, 601))
        reqs.append(Request(prompt=list(rng.randint(0, cfg.vocab_size,
                                                    size=n)),
                            max_new_tokens=32,
                            temperature=0.0 if i % 2 == 0 else 0.8))
    return reqs


def pressure_requests(vocab: int):
    """16 requests sharing a 256-token system prompt, each with a unique
    tail of 16-344 tokens and 32 new tokens, all greedy."""
    rng = np.random.RandomState(1)
    shared = list(rng.randint(0, vocab, size=256))
    return [Request(prompt=shared + list(rng.randint(
        0, vocab, size=int(rng.randint(16, 345)))), max_new_tokens=32)
        for _ in range(16)]


#: pages of the pressure run's pool (scratch page included): small enough
#: that the run preempts, found with the smoke model on the CPU (paging
#: decisions depend only on token counts and prefix equality)
PRESSURE_BLOCKS = 57


def run_stepwise(eng, check):
    """``eng.run()`` one step at a time: after each step ``check(before,
    after, programs)`` gets the launch counts around it and the DEP
    programs of its model calls. Returns the requests finished."""
    start = len(eng.finished)
    while True:
        before, n = kernel_lib.launch_counts(), len(eng.stats.programs)
        busy = eng.step()
        check(before, kernel_lib.launch_counts(), eng.stats.programs[n:])
        if not busy and not eng.waiting:
            return eng.finished[start:]


def serve(eng, reqs, cfg, path: str, expect, step_check=None):
    """Drive ``reqs`` through ``eng`` with the launch counts set to 0 just
    before and read just after (and ``step_check``, if given, after every
    step: ``run_stepwise``); check that every request finished with 32
    tokens of the vocabulary and that every kernel launched exactly as
    often as ``expect(eng.stats)`` says (a kernel absent from it must not
    launch). An engine with the decode graph must replay it at every
    decode step and capture no key twice (one capture per graph it
    holds); an eager one must capture nothing."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    kernel_lib.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    finished = (eng.run() if step_check is None
                else run_stepwise(eng, step_check))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_lib.launch_counts()
    if len(finished) != len(reqs):
        fail(f"{path}: served {len(finished)}/{len(reqs)} requests")
    for r in reqs:
        if r.state != RequestState.FINISHED or len(r.output) != 32:
            fail(f"{path}: request {r.request_id}: {r.state} with "
                 f"{len(r.output)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            fail(f"{path}: request {r.request_id}: token out of the "
                 "vocabulary")
    st = eng.stats
    want = expect(st)
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{path}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)}")
    if eng.decode_graph:
        if st.graph_captures != len(eng._graphs.graphs):
            fail(f"{path}: {st.graph_captures} graph captures for "
                 f"{len(eng._graphs.graphs)} keys")
        if st.graph_replays != st.steps:
            fail(f"{path}: {st.graph_replays} graph replays for {st.steps} "
                 "decode steps")
    elif st.graph_captures or st.graph_replays:
        fail(f"{path}: an eager engine captured or replayed a graph")
    tokens = sum(len(r.output) for r in reqs)
    ttft = np.array([r.ttft for r in reqs]) * 1e3
    res = dict(requests=len(finished), tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, ttft_mean_ms=float(ttft.mean()),
               ttft_p90_ms=float(np.percentile(ttft, 90)),
               decode_steps=st.steps,
               decode_step_ms=st.decode_s / st.steps * 1e3,
               prefill_calls=st.prefill_calls,
               prefill_ms_mean=st.prefill_s / st.prefill_calls * 1e3,
               decode_graph=eng.decode_graph,
               graph_captures=st.graph_captures,
               graph_replays=st.graph_replays, graph_s=st.graph_s,
               allocated_at_start_gb=start_gb,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               launches=counts)
    print(f"[{path}] {tokens} tokens for {len(finished)} requests in "
          f"{wall:.2f} s -> {res['tokens_per_s']:.1f} tokens/s; TTFT mean "
          f"{res['ttft_mean_ms']:.0f} ms, p90 {res['ttft_p90_ms']:.0f} ms; "
          f"{st.steps} decode steps at {res['decode_step_ms']:.2f} ms; "
          f"{st.prefill_calls} prefill calls at "
          f"{res['prefill_ms_mean']:.1f} ms; peak memory "
          f"{res['peak_mem_gb']:.2f} GB allocated ({start_gb:.2f} at the "
          f"start), {res['peak_reserved_gb']:.2f} GB reserved")
    print(f"[{path}] decode graph "
          + (f"on: {st.graph_captures} captures, {st.graph_replays} replays "
             f"for {st.steps} decode steps, warm-up and captures "
             f"{st.graph_s:.2f} s" if eng.decode_graph else "off (eager)"))
    print(f"[{path}] launches: {counts}")
    print(f"[{path}] " + json.dumps(res))
    return counts


def moe_expect(cfg, decode_kernel: str):
    """Launches of the qwen2-moe serve: per layer one decode attention
    and one expert GEMM per decode step, one flash attention and one
    expert GEMM per prefill call."""
    L = cfg.num_layers
    return lambda st: {decode_kernel: L * st.steps,
                       "flash_attention": L * st.prefill_calls,
                       "moe_gemm": L * (st.steps + st.prefill_calls)}


#: prompt lengths of the teacher-forced graph-against-eager phases: mixed,
#: and the first (Lp = 59, pages of 32 up to position 63) writes position
#: 64 at its sixth decode step, so a paged run opens a page mid-window
FORCED_LENGTHS = (60, 16, 137, 250, 301, 404, 517, 600)


def teacher_forced(path, graph_eng, eager_eng, cfg, prompts,
                   steps: int = 10, names=("graph", "eager")) -> None:
    """The graph engine against the eager engine (or any two engines,
    ``names``) on the same weights: both admit the same prompts (even
    ones greedy, odd ones at T=0.8) and decode ``steps`` + 1 steps, every
    step after the first fed the same tokens, drawn from a seed rather
    than sampled. The logits of every step must be bitwise equal (every
    row, dead ones included); under paged KV at least one step must
    decode after a table change."""
    engines = (graph_eng, eager_eng)
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(Request(prompt=list(p), max_new_tokens=steps + 4,
                               temperature=0.0 if i % 2 == 0 else 0.8))
    paged = graph_eng.kv_layout == "paged"
    rng = np.random.RandomState(10)
    after_change = 0
    for k in range(steps + 1):
        before = graph_eng.kv._tables.copy() if paged else None
        if k:
            forced = torch.from_numpy(rng.randint(
                0, cfg.vocab_size, size=(graph_eng.num_slots, 1)))
            for eng in engines:
                eng.last_tokens.copy_(forced)
        for eng in engines:
            eng.step()
        got, want = graph_eng.last_logits, eager_eng.last_logits
        if not torch.equal(got, want):
            diff = (got.float() - want.float()).abs()
            rows = sorted({int(r) for r in (diff > 0).nonzero()[:, 0]})
            fail(f"{path}: {names[0]} and {names[1]} logits differ at "
                 f"decode step {k} in {int((diff > 0).sum())} entries of "
                 f"rows {rows}, by up to {float(diff.max()):.3e}")
        if paged and not np.array_equal(before, graph_eng.kv._tables):
            after_change += 1
    if paged and not after_change:
        fail(f"{path}: no teacher-forced step followed a table change")
    live = sorted(graph_eng.kv.length(s) for s in graph_eng.kv.live_slots())
    for eng in engines:
        eng.run()
    print(f"[{path}] {names[0]} vs {names[1]}, teacher-forced: logits "
          f"bitwise equal at all {steps + 1} decode steps (live slots at "
          f"lengths {live} "
          f"after them" + (f"; {after_change} steps after a table change"
                           if paged else "") + ")")


def against_eager(path, graph_eng, eager_eng, cfg, graph_reqs, make_reqs,
                  expect, prompts) -> None:
    """The eager engine serves ``make_reqs()``, the requests the graph
    engine served as ``graph_reqs``: every greedy request must give the
    graph run's tokens (sampled ones match where the graph's generator
    draws as the eager one's). Then ``teacher_forced`` on ``prompts``."""
    reqs = make_reqs()
    serve(eager_eng, reqs, cfg, f"{path} eager", expect)
    pairs = list(zip(graph_reqs, reqs))
    greedy = [(a, b) for a, b in pairs if a.temperature == 0]
    sampled = [(a, b) for a, b in pairs if a.temperature > 0]
    bad = [i for i, (a, b) in enumerate(pairs)
           if a.temperature == 0 and a.output != b.output]
    if bad:
        fail(f"{path}: greedy requests {bad} differ between the graph and "
             "the eager run")
    same = sum(a.output == b.output for a, b in sampled)
    print(f"[{path}] graph vs eager serve: all {len(greedy)} greedy "
          f"requests give the same tokens; {same}/{len(sampled)} sampled "
          "requests too")
    teacher_forced(path, graph_eng, eager_eng, cfg, prompts)


def forced_prompts(vocab: int, shared=()):
    """Prompts of ``shared`` and then ``FORCED_LENGTHS`` random tokens,
    from a seed (a shared prefix of whole pages keeps the page crossing
    of ``FORCED_LENGTHS[0]``)."""
    rng = np.random.RandomState(12)
    return [list(shared) + list(rng.randint(0, vocab, size=n))
            for n in FORCED_LENGTHS]


def phase_serve():
    """The paged path with the dense footprint as its pool, then the dense
    path (slice 1) on the same weights, whose tokens the paged run must
    give; then paged KV under pool pressure (preemption). Paged runs
    first so that the order of the phases does not favour it. Each path
    runs with the decode graph and is held against an eager engine on
    the same weights; a paired timing takes turns between the dense graph,
    the dense eager and the paged graph engines. Returns the launch counts
    of each path's graph run."""
    cfg = get_config("qwen2-moe-a2.7b")
    t0 = time.perf_counter()
    # paged, parity pool: the dense footprint (257 pages of 32)
    eng = ServingEngine(cfg, num_slots=8, max_context=1024,
                        kv_layout="paged", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.num_shared_experts} shared, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.2f} B params in bf16 drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    counts = {}
    paged_reqs = mixed_requests(cfg)
    expect = moe_expect(cfg, "decode_attention_paged")
    counts["paged"] = serve(eng, paged_reqs, cfg, "paged", expect)
    eng.kv.check_invariants()
    pool = (eng.kv.pool.num_blocks, eng.kv.block_size)
    print(f"[paged] paging_stats {json.dumps(eng.paging_stats())}")
    profile_decode(eng, np.random.RandomState(5), cfg, "paged")
    params = eng.params
    eager = ServingEngine(cfg, params=params, num_slots=8, max_context=1024,
                          kv_layout="paged", dtype=torch.bfloat16, seed=0,
                          decode_graph=False)
    against_eager("paged", eng, eager, cfg, paged_reqs,
                  lambda: mixed_requests(cfg), expect,
                  forced_prompts(cfg.vocab_size))
    eager.kv.check_invariants()
    profile_decode(eager, np.random.RandomState(5), cfg, "paged eager")
    paged_eng = eng
    del eager
    torch.cuda.empty_cache()

    eng = ServingEngine(cfg, params=params, num_slots=8, max_context=1024,
                        dtype=torch.bfloat16, seed=0)
    dense_reqs = mixed_requests(cfg)
    expect = moe_expect(cfg, "decode_attention")
    counts["serve"] = serve(eng, dense_reqs, cfg, "serve", expect)
    print(f"[serve] (decode_attention {cfg.num_layers} per decode step)")
    profile_decode(eng, np.random.RandomState(5), cfg, "serve")
    profile_prefill(eng, np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(8, 300)), "serve")
    eager = ServingEngine(cfg, params=params, num_slots=8, max_context=1024,
                          dtype=torch.bfloat16, seed=0, decode_graph=False)
    against_eager("serve", eng, eager, cfg, dense_reqs,
                  lambda: mixed_requests(cfg), expect,
                  forced_prompts(cfg.vocab_size))
    profile_decode(eager, np.random.RandomState(5), cfg, "serve eager")
    greedy = [(a, b) for i, (a, b) in enumerate(zip(dense_reqs, paged_reqs))
              if i % 2 == 0]
    sampled = [(a, b) for i, (a, b) in enumerate(zip(dense_reqs, paged_reqs))
               if i % 2 == 1]
    bad = [i for i, (a, b) in enumerate(greedy) if a.output != b.output]
    if bad:
        fail(f"paged: greedy requests {bad} differ from the dense run")
    same = sum(a.output == b.output for a, b in sampled)
    print(f"[paged] pool {pool[0]} pages of {pool[1]}: all {len(greedy)} "
          f"greedy requests give the dense run's tokens; {same}/"
          f"{len(sampled)} sampled requests match too")
    compare_decode({"graph": eng, "eager": eager, "paged": paged_eng}, cfg)
    del eng, eager, paged_eng
    torch.cuda.empty_cache()

    # paged, under pressure: a shared system prompt and a pool that must
    # preempt
    def pressure_engine(**kw):
        return ServingEngine(cfg, params=params, num_slots=8,
                             max_context=1024, kv_layout="paged",
                             kv_block_size=32, kv_num_blocks=PRESSURE_BLOCKS,
                             dtype=torch.bfloat16, seed=0, **kw)

    eng = pressure_engine()
    reqs = pressure_requests(cfg.vocab_size)
    expect = moe_expect(cfg, "decode_attention_paged")
    counts["pressure"] = serve(eng, reqs, cfg, "pressure", expect)
    eng.kv.check_invariants()
    ps = eng.paging_stats()
    print(f"[pressure] paging_stats {json.dumps(ps)}")
    if ps["preemptions"] < 1:
        fail("pressure: the pool never preempted")
    if not ps["prefix_hit_rate"] > 0:
        fail("pressure: no prefix hits on a shared system prompt")
    if ps["blocks_used"] != ps["blocks_reclaimable"]:
        fail(f"pressure: {ps['blocks_used']} pages in use at the end, "
             f"{ps['blocks_reclaimable']} reclaimable (a leak)")
    print(f"[pressure] {ps['preemptions']} preemptions, prefix hit rate "
          f"{ps['prefix_hit_rate']:.3f}, invariants hold, every page "
          "free or reclaimable at the end")
    eager = pressure_engine(decode_graph=False)
    # a new shared prefix: admission counts parked prefix pages both as
    # free and as hits, so prompts on the parked one can over-commit the
    # pool (ROADMAP Queue 3)
    against_eager("pressure", eng, eager, cfg, reqs,
                  lambda: pressure_requests(cfg.vocab_size), expect,
                  forced_prompts(cfg.vocab_size, shared=np.random.RandomState(
                      14).randint(0, cfg.vocab_size, size=256)))
    if eager.paging_stats() != eng.paging_stats():
        fail(f"pressure: eager paging_stats {eager.paging_stats()} differ "
             f"from the graph run's {eng.paging_stats()}")
    print("[pressure] the eager engine's paging counters equal the graph "
          "engine's")
    for e in (eng, eager):
        e.kv.check_invariants()
    del eng, eager, params
    torch.cuda.empty_cache()
    return counts


def compare_decode(engines, cfg, steps: int = 8, rounds: int = 2) -> None:
    """Paired decode-step wall time of engines on the same host: they take
    turns A, B, ..., ..., B, A in each round, each turn 8 slots at
    300-token prompts decoding ``steps`` steps, so a drift of the host's
    speed weighs on all alike."""
    names = list(engines)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            eng = engines[name]
            rng = np.random.RandomState(7)
            for _ in range(eng.num_slots):
                eng.submit(Request(prompt=list(rng.randint(
                    0, cfg.vocab_size, size=300)), max_new_tokens=steps + 2))
            eng.step()                  # admit + prefill + first decode
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            times[name].append((time.perf_counter() - t0) * 1e3 / steps)
            eng.run()
    med = {name: float(np.median(t)) for name, t in times.items()}
    print(f"[compare {cfg.name}] decode step ms, turns {'/'.join(names)} "
          "alternating: " + json.dumps({"median": med, "turns": times}))


# ---------------------------------------------------------------------------
# phase 4b: the DEP path (the FinDEP planner and the DEP executor)
# ---------------------------------------------------------------------------

#: the expert group's backend (the CPU rehearsal takes gloo)
DEP_BACKEND = "nccl"


def dep_policy(cfg, profile):
    """The reference's serving policy (``examples/serve_moe.py``): FinDEP
    on the paper's layout of 3 attention + 5 expert devices with an
    8-sample memory cap, solved on ``profile`` (the calibrate phase's
    measured H100 profile; ``PAPER_A6000`` for the comparison)."""
    return FinDEPPolicy(FinDEPPlanner(cfg, DepClusterConfig(8, 3, 5),
                                      profile,
                                      PlannerConfig(mem_cap_samples=8)))


def exp_launches(programs, layers: int) -> int:
    """Expert-GEMM launches of the model calls that walked ``programs``
    (("prefill" or "decode", ExecProgram) pairs): one per MoE layer and
    (stream, chunk)."""
    return layers * sum(p.graph.r1 * p.graph.r2 for _, p in programs)


def dep_expect(cfg):
    """Launches of a DEP serve: attention as on the dense path, the
    expert GEMM once per layer and (stream, chunk) of each call's
    program."""
    L = cfg.num_layers
    return lambda st: {"decode_attention": L * st.steps,
                       "flash_attention": L * st.prefill_calls,
                       "moe_gemm": exp_launches(st.programs, L)}


def exp_per_step(cfg, path: str):
    """A ``run_stepwise`` check: every step launched the expert GEMM
    ``num_layers`` x the sum of r1·r2 over its model calls' programs."""
    def check(before, after, programs):
        n = after["moe_gemm"] - before["moe_gemm"]
        want = exp_launches(programs, cfg.num_layers)
        if n != want:
            fail(f"{path}: step {check.steps}: the expert GEMM launched {n} "
                 f"times, its programs ask for {want}")
        check.steps += 1
    check.steps = 0
    return check


def describe(program) -> str:
    g = program.graph
    return (f"r1={g.r1} r2={g.r2} m_e={g.m_e} {g.order} "
            f"{program.interleave}")


def print_plans(eng, path: str) -> None:
    """Every resolved plan with its key and the profile it was solved on;
    the DEP programs the model calls walked; the decode graph's keys."""
    profile = eng.plan_policy.planner.hardware.name
    for key, plan in eng.resolved_plans().items():
        print(f"[{path}] plan {key}: m_a={plan.m_a} r1={plan.r1} "
              f"m_e={plan.m_e:g} r2={plan.r2} order={plan.order} "
              f"(solved on the {profile} profile)")
    runs = {}
    for phase, prog in eng.stats.programs:
        runs[(phase, prog)] = runs.get((phase, prog), 0) + 1
    for (phase, prog), n in runs.items():
        print(f"[{path}] {phase} program {describe(prog)}: {n} model calls")
    if eng._graphs is not None:
        for key in eng._graphs.graphs:
            print(f"[{path}] decode graph key use_topk={key.use_topk} "
                  f"program {describe(key.plan)}: captured once")


def print_plans_beside(eng, cfg, path: str) -> None:
    """Every plan ``eng`` resolved (on its measured profile) beside the
    plan ``PAPER_A6000`` gives the same (bucket, batch) or occupancy."""
    a6000 = PlanCache(dep_policy(cfg, PAPER_A6000))
    rows = []

    def fields(p):
        return dict(m_a=p.m_a, r1=p.r1, m_e=p.m_e, r2=p.r2, order=p.order,
                    makespan_s=p.makespan)

    for key, plan in eng.resolved_plans().items():
        phase, *rest = key
        if phase == "decode":
            other = a6000.get("decode", occupancy=rest[0])
        else:
            other = a6000.get(phase, rest[0], rest[1])
        rows.append(dict(key=repr(key), measured=fields(plan),
                         paper_a6000=fields(other)))
        print(f"[{path}] plan {key}: measured profile m_a={plan.m_a} "
              f"r1={plan.r1} m_e={plan.m_e:g} r2={plan.r2} {plan.order} "
              f"makespan {plan.makespan * 1e3:.4f} ms | PAPER_A6000 "
              f"m_a={other.m_a} r1={other.r1} m_e={other.m_e:g} "
              f"r2={other.r2} {other.order} makespan "
              f"{other.makespan * 1e3:.4f} ms")
    print(f"[{path}] plans beside PAPER_A6000: " + json.dumps(rows))


def print_telemetry(eng, path: str) -> None:
    """The engine's telemetry, as ``examples/serve_moe.py`` prints it:
    measured against predicted seconds and the residual per phase, then
    per plan key (observations after each key's first, its EWMA)."""
    for phase, st in sorted(eng.telemetry.summary().items()):
        res = st["residual"]
        print(f"[{path}] telemetry {phase:>7}: n={st['count']:<4} measured="
              f"{st['measured_s']:.4f}s predicted={st['predicted_s']:.6f}s "
              + (f"residual={res:+.1%}" if res is not None
                 else "residual=n/a"))
    for key, st in eng.telemetry.keys.items():
        res = ((st.measured_s - st.predicted_s) / st.predicted_s
               if st.predicted_s > 0 else None)
        print(f"[{path}] telemetry key {key}: n={st.count} measured="
              f"{st.measured_s:.4f}s predicted={st.predicted_s:.6f}s "
              + (f"residual={res:+.1%} ewma={st.residual_ewma:+.1%}"
                 if res is not None else "residual=n/a"))


def forced_program() -> ExecProgram:
    """The program no plan of the serve resolves to: r1=2 streams x r2=4
    chunks, ASAS, streams interleaved (eight A2E/E2A pairs per layer)."""
    return ExecProgram(lower_exec(4, "ASAS", 1, r1=2), "streams")


class GemmWidths:
    """While entered, records the capacity width C of every expert-GEMM
    call of the model (``models.moe`` calls the wrapper through its
    module global; a graph capture calls it, a replay does not)."""

    def __enter__(self):
        self.widths = set()
        self._wrapped = moe_lib.moe_gemm

        def record(x, *args, **kw):
            self.widths.add(int(x.shape[1]))
            return self._wrapped(x, *args, **kw)
        moe_lib.moe_gemm = record
        return self

    def __exit__(self, *exc):
        moe_lib.moe_gemm = self._wrapped


def check_dep_layer(params, cfg, groups, programs, device) -> None:
    """One full-width MoE layer (layer 0 of the served weights, bf16) at
    world size 1, for every distinct program the serve walked and the
    forced r1=2 x r2=4 ASAS program: ``moe_apply_dep`` against
    ``moe_apply_capacity`` at the capacity the program's multiple gives.
    Bitwise equal where r2 = 1 and the shared expert runs as one segment;
    elsewhere within ``GEMM_TOL`` (cuBLAS may pick another algorithm for a
    row range of the shared GEMM). Both sides reach the same expert-GEMM
    kernel, so this holds the walk, not the kernel: ``check_dep_widths``
    holds the kernel against its plain version at the same widths."""
    p = params["layers"][0]["moe"]
    M = cfg.d_model
    shapes = {"decode": (8, 1), "prefill": (2, 512)}
    cases = list(dict.fromkeys(programs)) + [("decode", forced_program())]
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    for phase, prog in cases:
        B, S = shapes[phase]
        x = torch.randn((B, S, M), generator=gen, device=device).to(
            torch.bfloat16)
        cap = moe_lib.expert_capacity(B * S, cfg.moe,
                                      multiple_of=prog.capacity_multiple)
        got, _ = moe_apply_dep(p, x, cfg.moe, groups, plan=prog,
                               with_aux=False)
        want, _ = moe_lib.moe_apply_capacity(p, x, cfg.moe, capacity=cap)
        g = prog.graph
        exact = g.r2 == 1 and g.r1 * g.shared_segments == 1
        err = float((got.float() - want.float()).abs().max())
        if exact:
            if not torch.equal(got, want):
                fail(f"dep layer {phase} {describe(prog)}: not bitwise "
                     f"equal to the capacity path (max |d| {err:.3e})")
            verdict = "bitwise equal"
        else:
            ratio = _worst(got.float(), want.float(), GEMM_TOL[torch.bfloat16])
            if not torch.isfinite(got).all() or ratio > 1:
                fail(f"dep layer {phase} {describe(prog)}: {ratio:.2f} of "
                     "GEMM_TOL against the capacity path")
            verdict = (f"within GEMM_TOL (worst {ratio:.3f} of the limit, "
                       f"max |d| {err:.3e})")
        print(f"[dep layer] {phase} x{list(x.shape)} {describe(prog)}, "
              f"capacity {cap}: {verdict}")


def check_dep_widths(p, widths, device) -> None:
    """The expert-GEMM kernel against its plain version at every width C
    the DEP path gave it, bf16 at ``GEMM_TOL``: on the served expert
    weights (what the serve ran), and on weights at ``check_moe_gemm``'s
    scale (outputs ~0.6) beside its controls, which must fail the limit
    in every row they change, so that the limit can see a fault at each
    width. Prints each comparison's worst ratio; any above 1 fails."""
    ex = p["experts"]
    E, M, H = ex["gate"].shape
    gen = torch.Generator(device=device)
    gen.manual_seed(4)

    def draw(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    scaled = (draw((E, M, H), M ** -0.5), draw((E, M, H), M ** -0.5),
              draw((E, H, M), H ** -0.5))
    worst = {}
    for c in widths:
        x = draw((E, c, M))
        for label, ws in (("served", (ex["gate"], ex["up"], ex["down"])),
                          ("scaled", scaled)):
            name = f"dep width E={E} C={c} M={M} H={H} {label} weights"
            got, want = moe_gemm(x, *ws), moe_gemm_ref(x, *ws)
            compare(name, got, want, torch.bfloat16,
                    GEMM_TOL[torch.bfloat16])
            worst[f"C={c} {label}"] = _worst(got.float(), want.float(),
                                             GEMM_TOL[torch.bfloat16])
            if label == "scaled":
                check_moe_gemm_controls(name, got, x, *ws, want)
            del got, want
    print(f"[dep layer] expert GEMM against its plain version at every DEP "
          f"width {sorted(widths)}: worst {max(worst.values()):.3f} of "
          "GEMM_TOL " + json.dumps(worst))


def back_to_back_ms(fn, calls: int = 20, iters: int = 5) -> float:
    """Device-bound time per call of ``fn``: CUDA events around ``calls``
    back-to-back calls (median of ``iters``). The card stays busy when a
    call's kernels outlast its host path, as the expert GEMM's 0.3 ms and
    more do, so this is the kernels' time and the gaps between them."""
    return time_ms(lambda: [fn() for _ in range(calls)],
                   iters=iters) / calls


def time_dep_chunks(p, widths, device) -> dict:
    """Time of one expert-GEMM launch over every expert at each DEP chunk
    width C (weights bf16, as served): CUDA events around one call, and
    around 20 back-to-back calls, which must not read below the bound.
    Not the profiler: late in a run its traces of these calls come back
    without their last kernels, every time (``device_ms`` counts them and
    fails). Returns {C: [events ms, back-to-back ms, bound ms]}."""
    ex = p["experts"]
    E, M, H = ex["gate"].shape
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    res = {}
    for c in widths:
        x = torch.randn((E, c, M), generator=gen, device=device).to(
            torch.bfloat16)
        b, _ = bound_ms((2 * E * c * M + 3 * E * M * H) * 2,
                        6.0 * E * c * M * H, torch.bfloat16)

        def call():
            return moe_gemm(x, ex["gate"], ex["up"], ex["down"])
        res[c] = [time_ms(call), back_to_back_ms(call), b]
        if res[c][1] < b:
            fail(f"dep width C={c}: the expert GEMM read {res[c][1]:.4f} ms "
                 f"a call back to back, below its bound {b:.4f} ms")
    print("[dep layer] expert GEMM ms per launch at the DEP chunk widths "
          "(C: [events one call, events over 20 back-to-back calls, "
          "bound]): " + json.dumps(res))
    return res


def time_dep_alltoall(groups, widths, M, E, device) -> None:
    """Time of one A2E all_to_all_single over the expert group ([E, C, M]
    bf16) at each DEP chunk width C, CUDA events around each call (the
    profiler records no device event for it outside a graph; inside one,
    at world size 1, it is a device-to-device copy)."""
    res = {}
    for c in widths:
        send = torch.zeros((E, c, M), dtype=torch.bfloat16, device=device)
        recv = torch.empty_like(send)
        res[c] = time_ms(lambda: torch.distributed.all_to_all_single(
            recv, send, group=groups.expert))
    print(f"[dep layer] all_to_all ms per call over {groups.expert_size} "
          "rank(s) at the DEP chunk widths (C: ms, events): "
          + json.dumps(res))


def force_decode_program(eng, program):
    """Make every decode step of ``eng`` walk ``program`` in place of the
    one its decode plan lowers to (prefill keeps its plans). The override
    holds the engine weakly: through a cycle a dropped engine, its
    weights included, would stay on the card until the collector ran."""
    exec_program = type(eng)._exec_program
    ref = weakref.ref(eng)

    def forced(plan, streams=None):
        return (program if streams is None
                else exec_program(ref(), plan, streams))
    eng._exec_program = forced
    return eng


def check_forced_graph(engine, params, cfg) -> None:
    """The forced r1=2 x r2=4 program in a real CUDA graph: eight A2E/E2A
    pairs per layer on the comm stream, each ordered by its (stream,
    chunk) events, forked from and joined into the capture stream. A
    graph engine whose every decode step walks it, against an eager one
    with the same override, teacher-forced: the logits must be bitwise
    equal at every step; the graph engine must hold one graph, of that
    program, captured once (after the engine's one warm-up on the
    unchunked program) with 24 x 8 expert-GEMM launches and replayed at
    every step; both engines' launches must equal 24 x sum(r1*r2) over
    their calls' programs."""
    prog = forced_program()
    graph = force_decode_program(engine(params), prog)
    eager = force_decode_program(engine(params, decode_graph=False), prog)
    kernel_lib.reset_launch_counts()
    teacher_forced("dep forced", graph, eager, cfg,
                   forced_prompts(cfg.vocab_size))
    L = cfg.num_layers
    n = kernel_lib.launch_counts()["moe_gemm"]
    want = (exp_launches(graph.stats.programs, L)
            + exp_launches(eager.stats.programs, L))
    if n != want:
        fail(f"dep forced: the expert GEMM launched {n} times, the programs "
             f"ask for {want}")
    decode = {p for ph, p in graph.stats.programs if ph == "decode"}
    keys = graph._graphs.graphs
    st = graph.stats
    if decode != {prog} or {k.plan for k in keys} != {prog}:
        fail(f"dep forced: decode walked {len(decode)} programs, graphs of "
             f"{len(keys)}; want the forced program alone")
    launches = [c.launches["moe_gemm"] for c in keys.values()]
    if (st.graph_captures != len(keys) or st.graph_replays != st.steps
            or launches != [L * 8] * len(keys)):
        fail(f"dep forced: {st.graph_captures} captures of {len(keys)} "
             f"keys, {st.graph_replays} replays for {st.steps} steps, "
             f"{launches} expert-GEMM launches per replay (want {L * 8})")
    print(f"[dep forced] {describe(prog)} captured once per key "
          f"({len(keys)}), {L * 8} expert-GEMM launches per replay, "
          f"{st.graph_replays} replays for {st.steps} steps; launches "
          f"{n} = {L} x sum(r1*r2) of both engines' calls")


#: the drift phase's residual threshold (|EWMA residual|) and samples per
#: key before it may trip, and how often its engine polls the profile
#: store (max age 0: every poll re-calibrates). A finished re-calibration
#: restarts every key's residual history and a drift episode waits for
#: the worker to be idle, so drift can trip only between calibrations: a
#: poll every 0.5 s kept the worker busy through the serve on an H100 (a
#: sweep took 1.2 s under load) and no drift event tripped.
DRIFT_THRESHOLD = 0.5
DRIFT_MIN_SAMPLES = 1
DRIFT_POLL_S = 1.5


def check_drift(engine, params, cfg, store_dir: str, clean) -> None:
    """A dep engine with ``drift_threshold`` and ``recalibrate_max_age_s=0``
    over a fresh store under ``store_dir`` serves the dep phase's requests
    on its weights, one step at a time: the re-calibrations run on the
    refresh worker, on the engine's calibration stream, while it serves. Every request
    must finish with 32 tokens, the graph replay once per decode step and
    capture no key twice, the expert GEMM launch 24 x sum(r1·r2) of the
    calls' programs (the calibration does not launch it; the attention
    kernels' counts include its sweeps), and at least one re-calibration
    and one re-solve must land before the serve ends. Prints the drift
    events, re-solves, re-calibrations and the programs first captured
    mid-serve, with the step at which each showed, and each
    re-calibration's betas against ``clean`` (the calibrate phase's
    profile, taken on an idle card)."""
    eng = engine(params, drift_threshold=DRIFT_THRESHOLD,
                 drift_min_samples=DRIFT_MIN_SAMPLES,
                 profile_store=os.path.join(store_dir, "drift"),
                 recalibrate_max_age_s=0.0)
    eng.recalibrator.poll_interval_s = DRIFT_POLL_S
    recals, calibrate_fn, stats = [], eng.recalibrator.calibrate_fn, eng.stats

    def recorded():
        """The engine's calibration job, noting the decode steps it
        overlapped (``stats``, not the engine: no cycle through it)."""
        start, s0 = stats.steps, time.perf_counter() - t0
        res = calibrate_fn()
        recals.append(dict(
            steps=[start, stats.steps],
            s=[s0, time.perf_counter() - t0], wall_s=res.wall_s,
            beta_vs_idle={k: getattr(res.profile, k).beta
                          / getattr(clean, k).beta for k in res.fit_r2},
            fit_r2=res.fit_r2))
        return res
    eng.recalibrator.calibrate_fn = recorded
    # the graphs' warm-up before the first poll, so that the first
    # re-calibration overlaps the serve and does not hold up the warm-up
    eng._ensure_caches()
    reqs = mixed_requests(cfg)
    kernel_lib.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    step, seen, events = 0, set(), []
    state = (0, 0, 0)
    while True:
        busy = eng.step()
        step += 1
        now = (eng.recalibrator.recalibrations, eng.plan_cache.stats.refreshes,
               eng.drift.stats.drift_events)
        if now != state:
            events.append(dict(step=step, s=time.perf_counter() - t0,
                               recalibrations=now[0], re_solves=now[1],
                               drift_events=now[2]))
            state = now
        for key in set(eng._graphs.graphs) - seen:
            seen.add(key)
            print(f"[drift] step {step}: captured use_topk={key.use_topk} "
                  f"program {describe(key.plan)}"
                  + (" (first met mid-serve)" if eng.stats.steps > 1 else ""))
        if not busy and not eng.waiting:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_recal, resolves = state[0], state[1]
    counts = kernel_lib.launch_counts()
    st = eng.stats
    eng.close()                     # waits for the worker's last job
    for r in reqs:
        if r.state != RequestState.FINISHED or len(r.output) != 32:
            fail(f"drift: request {r.request_id}: {r.state} with "
                 f"{len(r.output)} tokens")
    if (st.graph_replays != st.steps
            or st.graph_captures != len(eng._graphs.graphs)):
        fail(f"drift: {st.graph_replays} replays for {st.steps} steps, "
             f"{st.graph_captures} captures of {len(eng._graphs.graphs)} "
             "keys")
    L = cfg.num_layers
    if counts["moe_gemm"] != exp_launches(st.programs, L):
        fail(f"drift: the expert GEMM launched {counts['moe_gemm']} times, "
             f"the programs ask for {exp_launches(st.programs, L)}")
    if (counts["decode_attention"] < L * st.steps
            or counts["flash_attention"] < L * st.prefill_calls):
        fail(f"drift: attention launches {counts} below the serve's")
    if n_recal < 1 or resolves < 1:
        fail(f"drift: {n_recal} re-calibrations and {resolves} re-solves "
             "landed while serving; want at least one each")
    ds = eng.drift.stats
    print(f"[drift] served {len(reqs)} requests in {wall:.2f} s: "
          f"{st.steps} decode steps, {st.prefill_calls} prefill calls; "
          f"{st.graph_captures} captures ({len(seen)} keys), "
          f"{st.graph_replays} replays; while serving "
          f"{n_recal} re-calibrations and {resolves} re-solves; after the "
          f"worker drained {eng.recalibrator.recalibrations} and "
          f"{eng.plan_cache.stats.refreshes}; {ds.drift_events} drift "
          f"events over {ds.observations} observations (per key "
          f"{ds.per_key_events}, last at residual "
          f"{ds.last_drift_residual}, last scales {ds.last_scales})")
    print("[drift] events by step: " + json.dumps(events))
    print(f"[drift] launches {counts}")
    print("[drift] re-calibrations (decode steps and seconds they spanned, "
          "beta over the idle card's): " + json.dumps(recals))
    print_telemetry(eng, "drift")


def phase_serve_dep(profile, store_dir: str):
    """The DEP path: full qwen2-moe-a2.7b on the serve path's weights
    (seed 0) and its 16 requests, with the FinDEP policy and an NCCL
    expert group of one rank, so every MoE layer walks its plan's program
    (A2E/E2A all_to_all on the comm stream, the expert GEMM per (stream,
    chunk)). Checks: the expert GEMM's launches every step; greedy tokens
    and 11 teacher-forced steps' logits of the graph engine against an
    eager one; interleave "streams" against "off" bitwise; the forced
    r1=2 x r2=4 program captured in a graph against its eager run; one
    layer against the capacity path; the expert GEMM against its plain
    version at every width the path gave it. Profiles a decode step and
    a prefill admission and times the DEP graph engine against the
    capacity graph engine. Returns the launch counts of the serve."""
    cfg = get_config("qwen2-moe-a2.7b")
    # NCCL's bootstrap stays on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    groups = DepGroups.single(DEP_BACKEND)

    def engine(params=None, **kw):
        return ServingEngine(cfg, params=params, num_slots=8,
                             max_context=1024, dtype=torch.bfloat16, seed=0,
                             plan_policy=dep_policy(cfg, profile),
                             ep_group=groups, **kw)

    eng = engine()
    torch.cuda.synchronize()
    print(f"[dep] expert group: {DEP_BACKEND}, {groups.world_size} rank; "
          f"engine with weights drawn in {time.perf_counter() - t0:.1f} s")
    params = eng.params
    reqs = mixed_requests(cfg)
    expect = dep_expect(cfg)
    step_check = exp_per_step(cfg, "dep")
    with GemmWidths() as rec:
        counts = serve(eng, reqs, cfg, "dep", expect, step_check=step_check)
        print(f"[dep] the expert GEMM launched {cfg.num_layers} x "
              f"sum(r1*r2) of each step's programs at all "
              f"{step_check.steps} steps")
        print_plans(eng, "dep")
        print_plans_beside(eng, cfg, "dep")
        print_telemetry(eng, "dep")
        profile_decode(eng, np.random.RandomState(5), cfg, "dep")
        prompts = np.random.RandomState(8).randint(0, cfg.vocab_size,
                                                   size=(8, 300))
        chunk, _ = prefill_split(dep_policy(cfg, profile).resolve(
            "prefill", 512, 8), 8)
        profile_prefill(eng, prompts, "dep", calls=-(-8 // chunk))
        eager = engine(params, decode_graph=False)
        against_eager("dep", eng, eager, cfg, reqs,
                      lambda: mixed_requests(cfg), expect,
                      forced_prompts(cfg.vocab_size))
        del eager
        off = engine(params, interleave="off")
        teacher_forced("dep", eng, off, cfg, forced_prompts(cfg.vocab_size),
                       names=("streams", "off"))
        del off
        check_forced_graph(engine, params, cfg)
        torch.cuda.empty_cache()
        check_dep_layer(params, cfg, groups, eng.stats.programs, eng.device)
    widths = sorted(rec.widths)
    p = params["layers"][0]["moe"]
    check_dep_widths(p, widths, eng.device)
    time_dep_chunks(p, widths, eng.device)
    time_dep_alltoall(groups, widths, cfg.d_model,
                      p["experts"]["gate"].shape[0], eng.device)
    capacity = ServingEngine(cfg, params=params, num_slots=8,
                             max_context=1024, dtype=torch.bfloat16, seed=0)
    compare_decode({"dep graph": eng, "capacity graph": capacity}, cfg)
    del capacity
    check_drift(engine, params, cfg, store_dir, profile)
    del eng, params, p
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() / 1e9
    if left > 0.5:
        fail(f"dep: {left:.2f} GB still allocated after the phase: an "
             "engine outlived it")
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 4c: observability (the serve entry point, the device trace)
# ---------------------------------------------------------------------------

#: where the obs phase serves (the CPU rehearsal passes "cpu")
OBS_DEVICE = "cuda"


def check_obs_outputs(served, args) -> None:
    """The entry point's outputs read back: the trace file passes
    ``validate_chrome_trace`` and holds every span the tracer recorded;
    the JSONL parses and its TTFT histogram counts every finished
    request, as the Prometheus text parsed back does."""
    eng = served.engine
    n = len(served.finished)
    if n != len(served.requests) or any(
            r.state != RequestState.FINISHED for r in served.requests):
        fail(f"obs: served {n}/{len(served.requests)} requests")
    with open(args.trace_out) as f:
        obj = json.load(f)
    stats = validate_chrome_trace(obj)
    if stats["complete"] != len(eng.tracer):
        fail(f"obs: the trace file holds {stats['complete']} spans, the "
             f"tracer {len(eng.tracer)}")
    with open(args.metrics_out) as f:
        lines = [json.loads(line) for line in f]
    snap = lines[-1]["metrics"]
    samples = parse_prometheus(eng.metrics.render_prometheus())
    prom = {"repro_engine_ttft_seconds_count": [
                v for name, _, v in samples
                if name == "repro_engine_ttft_seconds_count"],
            'repro_engine_requests_total{state="finished"}': [
                v for name, labels, v in samples
                if name == "repro_engine_requests_total"
                and labels == {"state": "finished"}]}
    for name, values in prom.items():
        if snap.get(name) != n or values != [n]:
            fail(f"obs: {name} is {snap.get(name)} in the JSONL and "
                 f"{values} in the Prometheus text; {n} requests finished")
    cats = {}
    for sp in eng.tracer.spans:
        cats[sp.cat] = cats.get(sp.cat, 0) + 1
    print(f"[obs] trace {stats} valid, spans by category {cats}; "
          f"{len(lines)} JSONL line(s), {len(samples)} Prometheus samples "
          "parsed back")


def check_obs_twin(served, args, cfg) -> None:
    """The untraced twin (``tracer=None, metrics=False``) on the same
    weights serves the same requests: the same greedy tokens, the same
    graph keys and captures; both capture no key twice and replay once
    per decode step; and a profiled decode step makes as many host
    launch calls with the registry and the tracer as without, 1
    ``cudaGraphLaunch`` and 2 ``cudaLaunchKernel``: the default-on
    registry adds no launch and no sync to the step."""
    eng = served.engine
    twin = serve_moe.serve(args, serve_moe.build_engine(
        args, params=eng.params, tracer=None, metrics=False))
    if twin.engine.tracer is not None or twin.engine.metrics is not None:
        fail("obs: the twin engine traces or counts")
    pairs = [(a, b) for a, b in zip(served.requests, twin.requests)
             if a.temperature == 0]
    bad = [a.request_id for a, b in pairs if a.output != b.output]
    if not pairs or bad:
        fail(f"obs: greedy requests {bad} differ between the traced serve "
             "and the untraced twin")
    keys = [set(e._graphs.graphs) for e in (eng, twin.engine)]
    for e, name in ((eng, "traced"), (twin.engine, "twin")):
        st = e.stats
        if (st.graph_captures != len(e._graphs.graphs)
                or st.graph_replays != st.steps):
            fail(f"obs: {name} engine: {st.graph_captures} captures of "
                 f"{len(e._graphs.graphs)} keys, {st.graph_replays} replays "
                 f"for {st.steps} decode steps")
    if keys[0] != keys[1]:
        fail(f"obs: the traced engine captured {len(keys[0])} keys, the "
             f"twin {len(keys[1])}: not the same")
    rows = [profile_decode(e, np.random.RandomState(5), cfg, f"obs {name}")
            for e, name in ((eng, "traced"), (twin.engine, "twin"))]
    calls = [(r["cudaGraphLaunch"], r["cudaLaunchKernel"]) for r in rows]
    if calls[0] != calls[1] or calls[0] != (1, 2):
        fail(f"obs: (cudaGraphLaunch, cudaLaunchKernel) per decode step "
             f"traced {calls[0]}, twin {calls[1]}; want (1, 2) for both")
    print(f"[obs] twin: all {len(pairs)} greedy requests give the traced "
          f"serve's tokens; {len(keys[0])} graph keys, captured once each, "
          f"in both; per decode step (cudaGraphLaunch, cudaLaunchKernel) "
          f"{calls[0]} traced and {calls[1]} untraced")
    del twin


def modelled_schedule(planner, program, seq_len: int, m_a: float,
                      m_e: float):
    """The program's graph scheduled under the planner's stage models (the
    calibrated profile) at ``seq_len``: its ``ScheduleResult``."""
    st = StageTimes.from_models(planner.stage_models(seq_len), m_a, m_e)
    return schedule(program.graph, TaskCosts.from_stage_times(st))


def comm_over_exp(spans) -> float:
    """The share of the comm lanes' busy time (A2E and E2A) that EXP
    covers, on the spans' own clock."""
    lanes = lane_intervals(spans)
    comm = interval_union(lanes.get("A2E", []) + lanes.get("E2A", []))
    busy = interval_total(comm)
    if busy <= 0:
        return 0.0
    return 1.0 - interval_total(interval_subtract(
        comm, lanes.get("EG", []))) / busy


def check_device_trace(label, program, groups, p, mcfg, x, sched) -> None:
    """``trace_dep_execution`` of one layer under ``program``: the card
    still held when the host had enqueued the walk, the spans
    in the program's walk order (GATE and ATTN are the caller's), one EXP
    per (stream, chunk), the output bitwise the untraced call's, and
    every A2E/E2A span at least its all_to_all copy's bytes bound (a
    read and a write of the chunk at the card's rate), so that the pair
    bounds the copy and not only its enqueue. Prints per-kind device ms,
    executed against scheduled exposed comm and the comm-over-EXP
    share."""
    tr = trace_dep_execution(program, groups, params=p, mcfg=mcfg, x=x,
                             device=x.device)
    if tr.host_ahead is False:
        fail(f"obs trace {label}: the card caught up with the host before "
             "the walk was enqueued: the spans hold waits for the host")
    walk = [(t.kind, t.mb, t.chunk) for t in program.walk()
            if t.kind not in ("GATE", "ATTN")]
    got = [(sp.name, sp.arg("mb"), sp.arg("chunk")) for sp in tr.spans]
    if got != walk:
        fail(f"obs trace {label}: spans {got} are not the walk {walk}")
    g = program.graph
    exp = [(mb, c) for k, mb, c in got if k == "EXP"]
    if sorted(exp) != [(i, j) for i in range(g.r1) for j in range(g.r2)]:
        fail(f"obs trace {label}: EXP spans at {exp}, want one per "
             f"(stream, chunk) of r1={g.r1} x r2={g.r2}")
    if not torch.equal(tr.out, tr.untraced()):
        fail(f"obs trace {label}: the traced layer is not bitwise the "
             "untraced one")
    E, M = p["experts"]["gate"].shape[0], x.shape[-1]
    cap = moe_lib.expert_capacity(x.shape[0] * x.shape[1], mcfg,
                                  multiple_of=program.capacity_multiple)
    C = cap // (g.r1 * g.r2)
    copy_bound_s = 2 * E * C * M * x.element_size() / HBM_BYTES_PER_S
    for sp in tr.spans:
        if not 0 <= sp.start <= sp.end:
            fail(f"obs trace {label}: span {sp} out of order")
        if sp.name in ("A2E", "E2A") and sp.duration < copy_bound_s:
            fail(f"obs trace {label}: {sp.name} mb={sp.arg('mb')} "
                 f"chunk={sp.arg('chunk')} took {sp.duration * 1e3:.4f} ms, "
                 f"under its copy's bound {copy_bound_s * 1e3:.4f} ms: the "
                 "events do not bound the all_to_all")
    per_kind = {}
    for sp in tr.spans:
        per_kind[sp.name] = per_kind.get(sp.name, 0.0) + sp.duration * 1e3
    rep = attribute_overlap(tr.spans, sched)
    row = dict(program=describe(program), x=list(x.shape), capacity=cap,
               chunk=C, chunk_mb=E * C * M * x.element_size() / 1e6,
               spans=len(tr.spans), per_kind_ms=per_kind,
               makespan_ms=rep.makespan_executed * 1e3,
               exposed_executed_ms={k: v * 1e3 for k, v in
                                    rep.exposed_executed.items()},
               exposed_scheduled_ms={k: v * 1e3 for k, v in
                                     rep.exposed_modeled.items()},
               exposed_frac_executed=rep.exposed_frac_executed,
               exposed_frac_scheduled=rep.exposed_frac_modeled,
               makespan_scheduled_ms=rep.makespan_modeled * 1e3,
               comm_over_exp=comm_over_exp(tr.spans),
               copy_bound_ms=copy_bound_s * 1e3, wall_s=tr.wall_s,
               host_ahead=tr.host_ahead)
    print(f"[obs trace] {label} {row['program']} x{row['x']}, capacity "
          f"{cap} ({C} a chunk, {row['chunk_mb']:.1f} MB): device ms by "
          "kind " + ", ".join(f"{k} {v:.4f}" for k, v in per_kind.items())
          + f"; makespan {row['makespan_ms']:.4f} ms; exposed comm "
          f"executed {row['exposed_executed_ms']['total']:.4f} ms "
          f"({row['exposed_frac_executed']:.1%}) beside scheduled "
          f"{row['exposed_scheduled_ms']['total']:.4f} ms "
          f"({row['exposed_frac_scheduled']:.1%} of a modelled "
          f"{row['makespan_scheduled_ms']:.4f} ms); comm under EXP "
          f"{row['comm_over_exp']:.1%}; in walk order, one EXP per "
          "(stream, chunk), bitwise the untraced layer " + json.dumps(row))


def phase_obs(profile, store_dir: str) -> None:
    """The observability path. Serves full qwen2-moe-a2.7b through the
    port's entry point (``serve_moe.main``: --full --dep, 16 requests, 8
    slots, max_context 1024, on the calibrate phase's profile, with
    --trace-out and --metrics-out), reads both files back
    (``check_obs_outputs``) and holds the traced engine against an
    untraced twin (``check_obs_twin``). Then traces one MoE layer of the
    served weights on the card (``trace_dep_execution``: CUDA event pairs
    on the comm and compute streams) under the 8 x 300 prefill's planned
    program and the forced r1 = 2 x r2 = 4 one, each interleaved and not
    (``check_device_trace``). Prints its wall time."""
    t0 = time.perf_counter()
    cfg = get_config("qwen2-moe-a2.7b")
    out_dir = tempfile.mkdtemp(dir=store_dir)
    argv = ["--full", "--dep", "--device", OBS_DEVICE, "--requests", "16",
            "--slots", "8", "--max-context", "1024",
            "--profile", profile.name, "--profile-store", store_dir,
            "--trace-out", os.path.join(out_dir, "trace.json"),
            "--metrics-out", os.path.join(out_dir, "metrics.jsonl")]
    served = serve_moe.main(argv)
    args = serve_moe.build_parser().parse_args(argv)
    eng = served.engine
    if eng.plan_policy.planner.hardware != profile:
        fail("obs: the entry point did not plan on the calibrate phase's "
             "profile")
    check_obs_outputs(served, args)
    check_obs_twin(served, args, cfg)
    p, groups = eng.params["layers"][0]["moe"], eng.model.ctx.groups
    del served, eng
    torch.cuda.empty_cache()
    planner = dep_policy(cfg, profile).planner
    plan = dep_policy(cfg, profile).resolve("prefill", 512, 8)
    chunk, n_mb = prefill_split(plan, 8)
    gen = torch.Generator(device=OBS_DEVICE)
    gen.manual_seed(9)
    for interleave in ("streams", "off"):
        cases = (("planned 8 x 300 prefill",
                  plan.exec_program(streams=n_mb, interleave=interleave),
                  chunk, plan.m_a, plan.m_e),
                 ("forced", ExecProgram(forced_program().graph, interleave),
                  8, 4.0, None))
        for label, prog, B, m_a, m_e in cases:
            x = torch.randn((B, 512, cfg.d_model), generator=gen,
                            device=OBS_DEVICE).to(torch.bfloat16)
            if m_e is None:
                m_e = planner.stage_models(512).me_from_ma(m_a, prog.graph.r2)
            sched = modelled_schedule(planner, prog, 512, m_a, m_e)
            check_device_trace(f"{label} ({interleave})", prog, groups, p,
                               cfg.moe, x, sched)
            del x
    del p, groups
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() / 1e9
    if left > 0.5:
        fail(f"obs: {left:.2f} GB still allocated after the phase: an "
             "engine outlived it")
    torch.cuda.empty_cache()
    print(f"[obs] phase passed in {time.perf_counter() - t0:.1f} s")


def phase_serve_xlstm():
    """The xLSTM path: full xlstm-1.3b, every mLSTM layer through the
    mLSTM scan kernel at prefill and decode, with the decode graph; held
    against an eager engine on the same weights and timed beside it."""
    cfg = get_config("xlstm-1.3b")
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, num_slots=8, max_context=1024,
                        dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    kinds = eng.model.kinds
    n_m = kinds.count("mlstm")
    print(f"[xlstm] {cfg.name}: {cfg.num_layers} layers ({n_m} mLSTM + "
          f"{kinds.count('slstm')} sLSTM), d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B params drawn in bf16 on the card in "
          f"{time.perf_counter() - t0:.1f} s (ModelConfig.num_params() "
          f"says {cfg.num_params() / 1e9:.3f} B)")
    reqs = mixed_requests(cfg)

    def expect(st):
        return {"mlstm_scan": n_m * (st.steps + st.prefill_calls)}

    counts = serve(eng, reqs, cfg, "xlstm", expect)
    print(f"[xlstm] (mlstm_scan {n_m} per decode step and per prefill "
          "call)")
    profile_decode(eng, np.random.RandomState(5), cfg, "xlstm")
    profile_prefill(eng, np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(1, 600)), "xlstm")
    eager = ServingEngine(cfg, params=eng.params, num_slots=8,
                          max_context=1024, dtype=torch.bfloat16, seed=0,
                          decode_graph=False)
    against_eager("xlstm", eng, eager, cfg, reqs,
                  lambda: mixed_requests(cfg), expect,
                  forced_prompts(cfg.vocab_size))
    profile_decode(eager, np.random.RandomState(5), cfg, "xlstm eager")
    compare_decode({"graph": eng, "eager": eager}, cfg)
    del eng, eager
    torch.cuda.empty_cache()
    return counts


def hybrid_requests(cfg):
    """The first 14 of ``mixed_requests`` and two long prompts: 2040
    tokens (greedy), whose 2048-slot ring wraps during its decode, and
    3000 tokens (T=0.8), whose prefill rolls the ring."""
    rng = np.random.RandomState(6)
    long = [Request(prompt=list(rng.randint(0, cfg.vocab_size, size=n)),
                    max_new_tokens=32, temperature=t)
            for n, t in ((2040, 0.0), (3000, 0.8))]
    return mixed_requests(cfg)[:14] + long


def phase_serve_hybrid():
    """The hybrid path: full recurrentgemma-9b, every RG-LRU layer through
    the RG-LRU scan kernel at prefill and decode, every local-attention
    layer through the flash kernel at prefill and the plain ring SDPA at
    decode, with the decode graph; held against an eager engine on the
    same weights (the teacher-forced prompts include one whose ring wraps
    during the steps) and timed beside it."""
    cfg = get_config("recurrentgemma-9b")
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, num_slots=8, max_context=4096,
                        dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    kinds = eng.model.kinds
    n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
    print(f"[hybrid] {cfg.name}: {cfg.num_layers} layers ({n_rec} RG-LRU + "
          f"{n_attn} local attention, window {cfg.sliding_window}), d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, lru_width {cfg.recurrent.lru_width}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params drawn in bf16 on "
          f"the card in {time.perf_counter() - t0:.1f} s "
          f"(ModelConfig.num_params() says {cfg.num_params() / 1e9:.3f} B)")
    reqs = hybrid_requests(cfg)

    def expect(st):
        return {"rg_lru_scan": n_rec * (st.steps + st.prefill_calls),
                "flash_attention": n_attn * st.prefill_calls}

    counts = serve(eng, reqs, cfg, "hybrid", expect)
    print(f"[hybrid] (rg_lru_scan {n_rec} per decode step and per prefill "
          f"call, flash_attention {n_attn} per prefill call)")
    profile_decode(eng, np.random.RandomState(5), cfg, "hybrid")
    profile_prefill(eng, np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(1, 3000)), "hybrid")
    eager = ServingEngine(cfg, params=eng.params, num_slots=8,
                          max_context=4096, dtype=torch.bfloat16, seed=0,
                          decode_graph=False)
    prompts = forced_prompts(cfg.vocab_size)
    # positions 2043.. of a 2044-token prompt: its 2048-slot ring wraps at
    # the sixth teacher-forced step
    prompts[-1] = list(np.random.RandomState(13).randint(
        0, cfg.vocab_size, size=2044))
    against_eager("hybrid", eng, eager, cfg, reqs,
                  lambda: hybrid_requests(cfg), expect, prompts)
    profile_decode(eager, np.random.RandomState(5), cfg, "hybrid eager")
    compare_decode({"graph": eng, "eager": eager}, cfg)
    del eng, eager
    torch.cuda.empty_cache()
    return counts


#: the device-side names of the repo's CUDA kernels (src/repro_torch/csrc)
OWN_KERNELS = ("decode_attention_split_kernel",
               "decode_attention_combine_kernel", "moe_gemm_",
               "flash_attention_", "mlstm_scan_kernel",
               "mlstm_chunk_prep_kernel", "mlstm_chunk_scan_kernel",
               "rg_lru_scan_kernel", "rg_lru_scan_short_kernel")


#: wrapper launch counter -> (device event name filter, events per call)
TRACED = {"decode_attention": ("decode_attention_", 2),
          "decode_attention_paged": ("decode_attention_", 2),
          "moe_gemm": ("moe_gemm_", 2),
          "flash_attention": ("flash_attention_", 1),
          "rg_lru_scan": ("rg_lru_scan", 1)}


def traced_launches(prof, before, after, names=None) -> dict:
    """For the repo's kernels: {name filter: [device events in the trace,
    events the wrappers' launches between ``before`` and ``after`` make]}.
    The profiler can drop the tail of a trace; this shows how much of
    the kernels a profile's numbers hold."""
    want = {}
    for name, (pattern, per) in TRACED.items():
        if names is None or name in names:
            want[pattern] = want.get(pattern, 0) + per * (after[name]
                                                         - before[name])
    events = device_events(prof)
    got = {p: sum(p in e.name for e in events) for p in want}
    return {p: [got[p], want[p]] for p in want if want[p] or got[p]}


def profile_decode(eng, rng, cfg, path: str, steps: int = 3) -> dict:
    """Where a steady decode step's time goes: the wall time of ``steps``
    plain decode steps, then the same number under torch.profiler for the
    device time by kernel (the profiler's device events include the
    kernels a graph replay launches), the expert GEMM's and NCCL's share
    of it; the idle share is 1 - the time some kernel runs (the union of
    the kernels' spans: the DEP path's comm stream overlaps the compute
    stream) / plain wall time. Also counts the host's
    ``cudaGraphLaunch`` and ``cudaLaunchKernel`` calls. Returns the
    printed row."""
    for _ in range(eng.num_slots):
        eng.submit(Request(prompt=list(rng.randint(0, cfg.vocab_size,
                                                   size=300)),
                           max_new_tokens=2 * steps + 2))
    eng.step()                      # admit + prefill + first decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = kernel_lib.launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    traced = traced_launches(prof, before, kernel_lib.launch_counts())
    eng.run()
    per_kernel = {}
    for e in device_events(prof):
        us, n = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in per_kernel.values()) / 1e3 / steps
    if busy_ms <= 0:
        fail(f"profile {path}: the profiler recorded no kernel on the card")
    host_calls = {name: sum(e.name == name for e in prof.events()) / steps
                  for name in ("cudaGraphLaunch", "cudaLaunchKernel")}
    # the card's idle time inside the window: short gaps between device
    # ops (launch latency) apart from long ones (the host between steps)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events(prof))
    gaps = [b[0] - a[1] for a, b in zip(spans, spans[1:])]
    covered, end = 0.0, None
    for s, e in spans:               # the union of the kernels' spans
        if end is None or s > end:
            covered, end = covered + e - s, e
        elif e > end:
            covered, end = covered + e - end, e
    covered_ms = covered / 1e3 / steps
    row = dict(wall_ms=wall_ms, kernel_ms=busy_ms,
               device_ops=sum(n for _, n in per_kernel.values()) // steps,
               moe_gemm_ms=sum(us for name, (us, _) in per_kernel.items()
                               if "moe_gemm_" in name) / 1e3 / steps,
               nccl_kernel_ms=sum(us for name, (us, _) in per_kernel.items()
                                  if "nccl" in name.lower()) / 1e3 / steps,
               dtod_ms=per_kernel.get("Memcpy DtoD (Device -> Device)",
                                      (0.0, 0))[0] / 1e3 / steps,
               dtod=per_kernel.get("Memcpy DtoD (Device -> Device)",
                                   (0.0, 0))[1] // steps,
               busy_ms=covered_ms, idle=max(0.0, 1 - covered_ms / wall_ms),
               **host_calls,
               gaps_under_50us_ms=sum(g for g in gaps if 0 < g < 50)
               / 1e3 / steps,
               gaps_over_50us_ms=sum(g for g in gaps if g >= 50)
               / 1e3 / steps)
    print(f"[profile {path}] decode step, 8 slots at ~300-token contexts, "
          f"graph {'on' if eng.decode_graph else 'off'}: wall "
          f"{wall_ms:.2f} ms/step, kernels {busy_ms:.2f} ms/step "
          f"({row['device_ops']} device ops; expert GEMM "
          f"{row['moe_gemm_ms']:.2f}, NCCL kernels "
          f"{row['nccl_kernel_ms']:.2f}, {row['dtod']} device-to-device "
          f"copies {row['dtod_ms']:.2f}), device "
          f"idle share {row['idle']:.3f}; per step "
          f"{host_calls['cudaGraphLaunch']:g} "
          f"cudaGraphLaunch, {host_calls['cudaLaunchKernel']:g} "
          f"cudaLaunchKernel; gaps between device ops "
          f"{row['gaps_under_50us_ms']:.2f} ms/step under 50 us, "
          f"{row['gaps_over_50us_ms']:.2f} over " + json.dumps(row))
    print(f"[profile {path}] the repo's kernels in the trace / launched: "
          + json.dumps(traced))
    # the ten largest, then the repo's own kernels that fall below them
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for i, (name, (us, n)) in enumerate(ranked):
        if i < 10 or any(k in name for k in OWN_KERNELS):
            print(f"  {us / 1e3 / steps:8.3f} ms/step {n // steps:5d}/step  "
                  f"{name[:80]}")
    # the host side of the same window: operators and CUDA runtime calls
    # by self CPU time (profiled, so each is inflated by the tracing)
    host = sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host:
        print(f"  host {e.self_cpu_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d}/step  {e.key[:60]}")
    return row


def profile_prefill(eng, prompts, path: str, calls: int = 1) -> None:
    """Where one batched prefill admission's time goes: ``prompts`` (of
    one length, so one bucket: one call, or ``calls`` when the engine's
    plan chunks the group) admitted together, three times (each drained
    by one decode step): a warm-up, one timed by the engine's prefill
    clock, one under torch.profiler for the device time by kernel. Idle
    share = 1 - kernel time / the calls' wall time."""
    def admit(prof=None) -> float:
        for p in prompts:
            eng.submit(Request(prompt=list(p), max_new_tokens=1))
        torch.cuda.synchronize()
        s0, n0 = eng.stats.prefill_s, eng.stats.prefill_calls
        if prof is None:
            eng._admit()
        else:
            with prof:
                eng._admit()
                torch.cuda.synchronize()
        if eng.stats.prefill_calls != n0 + calls:
            fail(f"prefill {path}: {eng.stats.prefill_calls - n0} prefill "
                 f"calls, expected {calls}")
        ms = (eng.stats.prefill_s - s0) * 1e3
        eng.run()
        return ms

    admit()
    wall_ms = admit()
    before = kernel_lib.launch_counts()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    admit(prof)
    # the counts move on with the drain after the admission, which
    # launches no prefill kernel (flash, the chunked expert GEMM's r1·r2)
    traced = traced_launches(prof, before, kernel_lib.launch_counts(),
                             names=("flash_attention",))
    per_kernel = {}
    for e in device_events(prof):
        us, n = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in per_kernel.values()) / 1e3
    if busy_ms <= 0:
        fail(f"prefill {path}: the profiler recorded no kernel on the card")
    flash_ms = sum(us for name, (us, _) in per_kernel.items()
                   if "flash_attention_" in name) / 1e3
    gemm_ms = sum(us for name, (us, _) in per_kernel.items()
                  if "moe_gemm_" in name) / 1e3
    print(f"[prefill {path}] {calls} prefill call(s) of {len(prompts)} x "
          f"{len(prompts[0])} tokens in all: wall {wall_ms:.2f} ms, kernels "
          f"{busy_ms:.2f} ms ({sum(n for _, n in per_kernel.values())} "
          f"launches), device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f};"
          f" flash {flash_ms:.3f} ms ({flash_ms / busy_ms:.1%} of kernel "
          f"time), expert GEMM {gemm_ms:.3f} ms")
    print(f"[prefill {path}] flash kernels in the trace / launched: "
          + json.dumps(traced))
    own = {k: (sum(us for name, (us, _) in per_kernel.items() if k in name),
               sum(n for name, (_, n) in per_kernel.items() if k in name))
           for k in OWN_KERNELS}
    print(f"[prefill {path}] the repo's kernels: " + ", ".join(
        f"{k} {us / 1e3:.3f} ms in {n}" for k, (us, n) in own.items() if n))
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for i, (name, (us, n)) in enumerate(ranked):
        if i < 10 or any(k in name for k in OWN_KERNELS):
            print(f"  {us / 1e3:8.3f} ms/call {n:5d}/call  {name[:80]}")


def check_bounds(name: str, entry: dict) -> None:
    """Fail a kernel whose device time, at any shape of its entry, reads
    below the bound the entry gives for that shape: the card cannot go
    faster, so the profiler dropped some of its work."""
    for key in ("device_ms", "cold_device_ms"):
        if key in entry and "bound_ms" in entry \
                and entry[key] < entry["bound_ms"]:
            fail(f"{name}: {key} {entry[key]:.4f} is below its bound "
                 f"{entry['bound_ms']:.4f} ms")
    for sub, value in entry.items():
        if isinstance(value, dict):
            check_bounds(f"{name} {sub}", value)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------

#: the serve path whose run gives each kernel's launch count in the report
KERNEL_PATH = {"decode_attention": "dep", "moe_gemm": "dep",
               "flash_attention": "dep", "decode_attention_paged": "paged",
               "mlstm_scan": "xlstm", "rg_lru_scan": "hybrid"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-serve", action="store_true",
                    help="stop after the kernel and small-model phases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    entries = [check_decode(gen), check_decode_paged(gen),
               check_moe_gemm(gen), check_flash(gen), check_mlstm(gen),
               check_rg_lru(gen)]
    torch.cuda.empty_cache()
    phase_small()
    phase_ring()
    counts = {}
    cal_counts = {}
    if not args.no_serve:
        os.makedirs(os.path.join(ROOT, ".repro-profiles"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, ".repro-profiles")) as store_dir:
            profile, cal_counts = phase_calibrate(store_dir)
            torch.cuda.empty_cache()
            counts = phase_serve()
            counts["dep"] = phase_serve_dep(profile, store_dir)
            phase_obs(profile, store_dir)
            torch.distributed.destroy_process_group()
            counts["xlstm"] = phase_serve_xlstm()
            counts["hybrid"] = phase_serve_hybrid()

    report = []
    for e in entries:
        check_bounds(e["name"], e)
        path = KERNEL_PATH[e["name"]]
        launches = counts.get(path, {}).get(e["name"], 0)
        e = dict(e, route="cuda", launches=launches, launches_path=path,
                 calibrate_launches=cal_counts.get(e["name"], 0), ok=True)
        report.append(e)
        lib = ("none" if e["library_ms"] is None
               else f"{e['library_ms']:.3f}")
        dev = (f", {e['device_ms']:.4f} on the device"
               if "device_ms" in e else "")
        print(f"[report] {e['name']}: {e['ms']:.3f} ms{dev} (plain "
              f"{e['plain_ms']:.3f}, library {lib}, bound "
              f"{e['bound_ms']:.4f} by {e['bound_by']}) at {e['shape']}; "
              f"{launches} launches while serving the {path} path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(json.dumps({"kernels": report}))
    print(smi)
    if args.no_serve:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
