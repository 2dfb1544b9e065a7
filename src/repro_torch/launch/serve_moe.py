"""End-to-end serving driver (PyTorch counterpart of
``examples/serve_moe.py``, the paper's workload): batched requests
against an MoE model through the continuous-batching engine, with a
pluggable scheduling policy (the paper's FinDEP online planner by
default, or a baseline via --policy) and admission policy
(--admission fcfs|spf|token_budget, --token-budget N).

The same flags and the same printed summary as the reference: tokens/s,
TTFT mean and p90, TTFT and TPOT p50/p99 from the metrics registry's
histograms, the resolved plans, paging, telemetry and drift. The
planner's cost models come from ``repro_torch.profiling`` (--calibrate,
--profile NAME, --profile-store DIR, --drift-threshold X).

Observability (``repro_torch.obs``):

  --trace-out OUT.json       record phase, request-lifecycle and DEP task
                             spans and write a Perfetto-loadable Chrome
                             trace (validated before it is written)
  --metrics-out OUT.jsonl    append metrics-registry snapshots (final,
                             or every --metrics-interval seconds)

Flags of the port's own:

  --device DEV     where to serve (default: the CUDA card; "cpu" for the
                   plain versions)
  --full           the full config at bf16 (default: the smoke config at
                   f32, as the reference)
  --dep            serve through the DEP executor on an expert group of
                   one rank (NCCL on a CUDA device, gloo on the CPU): the
                   counterpart of the reference engine's ``mesh=``
  --max-context N  KV positions per slot (the reference's 256)

Expert placement (--replicate-hot-k, --rebalance-threshold) is not
ported yet (ROADMAP Queue 1 item 7): a non-default value raises.

Run:  python -m repro_torch.launch.serve_moe --device cpu --requests 4
      python -m repro_torch.launch.serve_moe --full --dep \\
          --trace-out trace.json --metrics-out metrics.jsonl
(with ``src`` on ``PYTHONPATH``).
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import DepClusterConfig
from repro_torch.core.dep import DepGroups
from repro_torch.core.perf_model import PAPER_A6000
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig
from repro_torch.obs import export_chrome_trace, validate_chrome_trace
from repro_torch.profiling import ProfileStore
from repro_torch.runtime import ADMISSIONS, Request, ServingEngine
from repro_torch.sched import POLICIES, make_policy


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_moe",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--policy", choices=POLICIES, default="findep",
                    help="scheduling policy for the MoE layers")
    ap.add_argument("--admission", choices=ADMISSIONS, default="fcfs",
                    help="request admission policy")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-step prefill token budget (chunked prefill)")
    ap.add_argument("--calibrate", action="store_true",
                    help="microbenchmark this host, fit + persist a "
                         "HardwareProfile, and plan from it")
    ap.add_argument("--profile", default=None,
                    help="plan from a stored/registry profile by name "
                         "(with --calibrate: the name to store under)")
    ap.add_argument("--profile-store", default=".repro-profiles",
                    help="ProfileStore root directory")
    ap.add_argument("--drift-threshold", type=float, default=None,
                    help="enable drift-triggered background plan refresh "
                         "at this |residual| (e.g. 0.5)")
    ap.add_argument("--replicate-hot-k", type=int, default=0,
                    help="replicate the K hottest experts onto every EP "
                         "rank (not ported yet: ROADMAP Queue 1 item 7)")
    ap.add_argument("--rebalance-threshold", type=float, default=None,
                    help="background expert re-placement threshold (not "
                         "ported yet: ROADMAP Queue 1 item 7)")
    ap.add_argument("--attn-impl", choices=("decode_kernel", "xla"),
                    default="decode_kernel",
                    help="decode attention: the split-KV decode kernel "
                         "or plain masked SDPA")
    ap.add_argument("--kv-layout", choices=("dense", "paged"),
                    default="dense",
                    help="KV memory: dense [B, max_context] rows or "
                         "block-granular pages with shared-prefix reuse")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens "
                         "to every request (shows the paged prefix cache)")
    ap.add_argument("--interleave", choices=("streams", "off"),
                    default="streams",
                    help="DEP executor emission: 'streams' interleaves "
                         "the r1 micro-batch streams in scheduled start "
                         "order; 'off' runs them back-to-back "
                         "(bit-identical outputs, different overlap)")
    ap.add_argument("--trace-out", default=None, metavar="OUT.json",
                    help="record engine spans (phases, request "
                         "lifecycles, DEP tasks) and write a "
                         "Chrome-trace/Perfetto JSON file")
    ap.add_argument("--metrics-out", default=None, metavar="OUT.jsonl",
                    help="append metrics-registry snapshots to this "
                         "JSONL file")
    ap.add_argument("--metrics-interval", type=float, default=None,
                    metavar="SECONDS",
                    help="with --metrics-out: snapshot every N seconds "
                         "while serving (default: one final snapshot)")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="the full config at bf16 (default: the smoke "
                         "config at f32)")
    ap.add_argument("--dep", action="store_true",
                    help="serve through the DEP executor on an expert "
                         "group of one rank (NCCL on CUDA, gloo on the "
                         "CPU)")
    ap.add_argument("--max-context", type=int, default=256,
                    help="KV positions per slot")
    return ap


def model_config(args):
    return get_config(args.arch) if args.full else get_smoke_config(args.arch)


def make_requests(cfg, args) -> List[Request]:
    """The reference's requests: prompts of 4-47 random tokens after
    ``--shared-prefix`` shared ones (``RandomState(0)``), even ones greedy
    and odd ones at temperature 0.8."""
    rng = np.random.RandomState(0)
    system = list(rng.randint(0, cfg.vocab_size, size=args.shared_prefix))
    reqs = []
    for i in range(args.requests):
        prompt = system + list(rng.randint(0, cfg.vocab_size,
                                           size=rng.randint(4, 48)))
        reqs.append(Request(prompt=[int(t) for t in prompt],
                            max_new_tokens=args.max_new,
                            temperature=0.0 if i % 2 == 0 else 0.8))
    return reqs


def build_engine(args, **overrides) -> ServingEngine:
    """The engine ``args`` describe; ``overrides`` replace its keyword
    arguments (e.g. ``params=``, ``tracer=None, metrics=False`` for an
    untraced twin on the same weights)."""
    cfg = model_config(args)
    device = resolve_device(args.device)
    policy = None
    if cfg.is_moe:
        planner = FinDEPPlanner(cfg, DepClusterConfig(8, 3, 5), PAPER_A6000,
                                PlannerConfig(mem_cap_samples=8))
        policy = make_policy(args.policy, planner, static_seq_len=256)
    groups = None
    if args.dep:
        if device.type == "cuda":
            # a group of one rank needs no interface but the loopback
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        groups = DepGroups.single("nccl" if device.type == "cuda"
                                  else "gloo")
    # placement is not ported: a non-default value reaches the engine,
    # which raises (ROADMAP Queue 1 item 7)
    placement = {k: v for k, v in (("replicate_hot_k", args.replicate_hot_k),
                                   ("rebalance_threshold",
                                    args.rebalance_threshold))
                 if v not in (0, None)}
    kw = dict(num_slots=args.slots, max_context=args.max_context,
              plan_policy=policy, admission=args.admission,
              token_budget=args.token_budget, calibrate=args.calibrate,
              profile=args.profile,
              profile_store=ProfileStore(args.profile_store),
              drift_threshold=args.drift_threshold,
              attn_impl=args.attn_impl, kv_layout=args.kv_layout,
              tracer=bool(args.trace_out), interleave=args.interleave,
              ep_group=groups,
              dtype=torch.bfloat16 if args.full else torch.float32,
              device=device, **placement)
    kw.update(overrides)
    return ServingEngine(cfg, **kw)


@dataclass
class Served:
    engine: ServingEngine
    requests: List[Request]
    finished: List[Request]
    wall_s: float


def serve(args, eng: Optional[ServingEngine] = None) -> Served:
    """Submit ``make_requests`` to ``eng`` (default: ``build_engine``)
    and run it until idle, snapshotting the registry every
    ``--metrics-interval`` seconds when asked."""
    eng = eng if eng is not None else build_engine(args)
    reqs = make_requests(eng.cfg, args)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    if args.metrics_out and args.metrics_interval:
        start = len(eng.finished)
        last_snap = t0
        while True:
            progressed = eng.step()
            now = time.perf_counter()
            if now - last_snap >= args.metrics_interval:
                eng.metrics.export_jsonl(args.metrics_out)
                last_snap = now
            if not progressed and not eng.waiting:
                break
        finished = eng.finished[start:]
    else:
        finished = eng.run()
    return Served(eng, reqs, finished, time.perf_counter() - t0)


def report(args, served: Served) -> None:
    """Print the reference's summary and write --trace-out and
    --metrics-out."""
    eng, reqs, dt = served.engine, served.requests, served.wall_s
    done = sum(len(r.output) for r in reqs)
    ttfts = [r.ttft for r in reqs if r.ttft is not None]
    print(f"\nserved {len(served.finished)}/{args.requests} requests / "
          f"{done} tokens in {dt:.1f}s -> {done/dt:.1f} tokens/s decode "
          f"on {eng.device}")
    print(f"TTFT: mean {np.mean(ttfts)*1e3:.0f} ms, "
          f"p90 {np.percentile(ttfts, 90)*1e3:.0f} ms")
    if eng.metrics is not None:
        # the registry's histograms over every finished request
        def _pcts(name):
            h = eng.metrics.histogram(name)
            return h.p50, h.p99, h.count
        t50, t99, tn = _pcts("repro_engine_ttft_seconds")
        p50, p99, pn = _pcts("repro_engine_tpot_seconds")
        if tn:
            print(f"TTFT p50 {t50*1e3:.0f} ms, p99 {t99*1e3:.0f} ms "
                  f"(n={tn}, log-bucket estimate)")
        if pn:
            print(f"TPOT p50 {p50*1e3:.0f} ms, p99 {p99*1e3:.0f} ms "
                  f"(n={pn})")
    print(f"first outputs: {[r.output[:6] for r in reqs[:3]]}")

    if eng.plan_cache is not None:
        s = eng.plan_cache.stats
        print(f"\npolicy={args.policy} admission={args.admission}: "
              f"{len(eng.plan_cache)} shapes resolved, "
              f"{s.hits} cache hits ({s.hit_rate:.0%}), "
              f"{s.solve_time_total*1e3:.1f} ms total solve time")
        entries = eng.resolved_plans().items()
        prefills = sorted(k for k, _ in entries if k[0] == "prefill")
        decodes = sorted(k for k, _ in entries if k[0] == "decode")
        plans = dict(entries)
        for key in prefills:
            phase, bucket, batch = key[:3]
            p = plans[key]
            print(f"  {phase:>7} bucket={bucket:<5} batch={batch}: "
                  f"m_a={p.m_a} r1={p.r1} r2={p.r2} {p.order}")
        for key in decodes:
            phase, occ = key[:2]
            p = plans[key]
            print(f"  {phase:>7} {occ!r}: "
                  f"m_a={p.m_a} r1={p.r1} r2={p.r2} {p.order}")

    paging = eng.paging_stats()
    if paging is not None:
        print(f"\npaged KV (block={paging['block_size']}): "
              f"{paging['blocks_used']}/{paging['blocks_usable']} pages "
              f"({paging['utilization']:.0%} pinned), prefix hit-rate "
              f"{paging['prefix_hit_rate']:.0%} "
              f"({paging['prefix_hit_tokens']} tokens), "
              f"{paging['preemptions']} preemptions")

    if eng.telemetry is not None and eng.telemetry.phases:
        print("\ntelemetry (predicted vs measured):")
        for phase, st in sorted(eng.telemetry.summary().items()):
            res = st["residual"]
            print(f"  {phase:>7}: n={st['count']:<4} "
                  f"measured={st['measured_s']:.3f}s "
                  f"predicted={st['predicted_s']:.3f}s "
                  + (f"residual={res:+.1%}" if res is not None else
                     "residual=n/a"))
    if eng.drift is not None:
        eng.drift.refresher.drain()
        ds, cs = eng.drift.stats, eng.plan_cache.stats
        print(f"drift: {ds.drift_events} events over {ds.observations} "
              f"observations -> {cs.refreshes} background re-solves "
              f"(threshold {args.drift_threshold:+.0%})")
        eng.close()

    if args.trace_out and eng.tracer is not None:
        obj = export_chrome_trace(args.trace_out, tracer=eng.tracer,
                                  meta={"arch": args.arch,
                                        "policy": args.policy,
                                        "device": str(eng.device)})
        stats = validate_chrome_trace(obj)
        print(f"\nwrote trace {args.trace_out}: {stats['complete']} spans "
              f"on {stats['tracks']} tracks (open in ui.perfetto.dev)")
    if args.metrics_out and eng.metrics is not None:
        eng.metrics.export_jsonl(args.metrics_out)
        print(f"wrote metrics snapshot -> {args.metrics_out}")


def main(argv=None) -> Served:
    """Parse ``argv``, serve, print the summary, write the outputs, and
    return what was served (the engine, the requests, the wall time)."""
    args = build_parser().parse_args(argv)
    eng = build_engine(args)
    if eng.calibration is not None:
        res = eng.calibration
        r2s = {k: round(v, 4) for k, v in res.fit_r2.items()}
        print(f"calibrated {res.profile.name!r} in {res.wall_s:.1f}s "
              f"(R^2 {r2s}"
              + (", comm=proxy" if res.comm_is_proxy else "")
              + f") -> {eng.profile_store.root}")
    elif args.profile:
        print(f"planning from profile {args.profile!r} "
              f"(store {eng.profile_store.root} or registry) — no "
              "re-measurement")
    served = serve(args, eng)
    report(args, served)
    return served


if __name__ == "__main__":
    main()
