"""End-to-end serving driver (PyTorch counterpart of
``examples/serve_moe.py``, the paper's workload): batched requests
against an MoE model through the continuous-batching engine, with a
pluggable scheduling policy (the paper's FinDEP online planner by
default, or a baseline via --policy) and admission policy
(--admission fcfs|spf|token_budget, --token-budget N).

The same flags and the same printed summary as the reference: tokens/s,
TTFT mean and p90, TTFT and TPOT p50/p99 from the metrics registry's
histograms, the resolved plans (with the skew each was solved under),
the expert load, paging, telemetry and drift. The planner's cost models
come from ``repro_torch.profiling`` (--calibrate, --profile NAME,
--profile-store DIR, --drift-threshold X).

Expert placement (``repro_torch.placement``), as in the reference:

  --replicate-hot-k K      replicate the K hottest experts onto every EP
                           rank when a re-balance lands (the REP task)
  --rebalance-threshold X  re-solve the expert -> rank map in the
                           background when the worst rank's observed
                           load exceeds X times the uniform share

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
  --ep-size N      serve DEP on N expert ranks (and --dp-size D data
  --dp-size D      ranks): D·N rank processes, spawned, in lock step
                   over a ``file://`` store in a temporary directory,
                   each holding E/N experts; the reference engine on a
                   (D, N) ("data", "model") mesh
  --backend B      the ranks' backend, "nccl" (a card per rank) or
                   "gloo" (the CPU, or ranks sharing a card; no decode
                   graph); needed with --ep-size or --dp-size
  --max-context N  KV positions per slot (the reference's 256)

Rank 0 prints the summary; the launcher checks that every rank served
the same tokens. --calibrate and --drift-threshold work on the ranks too:
every rank measures (the comm sweep over the live expert group) and plans
from rank 0's fit, which rank 0 alone stores.

Run:  python -m repro_torch.launch.serve_moe --device cpu --requests 4
      python -m repro_torch.launch.serve_moe --full --dep \\
          --trace-out trace.json --metrics-out metrics.jsonl
      python -m repro_torch.launch.serve_moe --device cpu --ep-size 2 \\
          --backend gloo
(with ``src`` on ``PYTHONPATH``).
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import tempfile
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
                         "rank at each re-balance (0 = no replication)")
    ap.add_argument("--rebalance-threshold", type=float, default=None,
                    help="background expert re-placement when the worst "
                         "rank's load exceeds this multiple of the "
                         "uniform share (e.g. 1.25; None = never)")
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
    ap.add_argument("--ep-size", type=int, default=1,
                    help="expert ranks of the DEP group (one process each)")
    ap.add_argument("--dp-size", type=int, default=1,
                    help="data ranks of the DEP group (one process each)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend of a group of several "
                         "ranks: nccl (a card per rank) or gloo (the CPU, "
                         "or ranks sharing a card)")
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


def build_engine(args, groups=None, **overrides) -> ServingEngine:
    """The engine ``args`` describe; ``groups`` is a rank's ``DepGroups``
    under --ep-size/--dp-size (``serve_rank``); ``overrides`` replace its
    keyword arguments (e.g. ``params=``, ``tracer=None, metrics=False`` for
    an untraced twin on the same weights)."""
    cfg = model_config(args)
    device = resolve_device(args.device)
    policy = None
    if cfg.is_moe:
        planner = FinDEPPlanner(cfg, DepClusterConfig(8, 3, 5), PAPER_A6000,
                                PlannerConfig(mem_cap_samples=8))
        policy = make_policy(args.policy, planner, static_seq_len=256)
    if groups is None and args.dep:
        if device.type == "cuda":
            # a group of one rank needs no interface but the loopback
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        groups = DepGroups.single("nccl" if device.type == "cuda"
                                  else "gloo")
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
              device=device, replicate_hot_k=args.replicate_hot_k,
              rebalance_threshold=args.rebalance_threshold)
    if (groups is not None and groups.world_size > 1
            and groups.backend == "gloo" and device.type == "cuda"):
        kw["decode_graph"] = False     # gloo stages through host memory
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
            skew = f" skew={key[3]!r}" if len(key) > 3 else ""
            p = plans[key]
            print(f"  {phase:>7} bucket={bucket:<5} batch={batch}: "
                  f"m_a={p.m_a} r1={p.r1} r2={p.r2} {p.order}{skew}")
        for key in decodes:
            phase, occ = key[:2]
            skew = f" skew={key[2]!r}" if len(key) > 2 else ""
            p = plans[key]
            print(f"  {phase:>7} {occ!r}: "
                  f"m_a={p.m_a} r1={p.r1} r2={p.r2} {p.order}{skew}")

    load = eng.expert_load()
    if load is not None:
        pl = eng.placement
        print(f"\nexpert load: imbalance {load['imbalance']:.2f}x uniform "
              f"(worst rank {load['rank_imbalance']:.2f}x), "
              f"{eng.stats.dropped_tokens} assignments dropped, "
              f"placement epoch {int(load['epoch'])}"
              + (f" (hot experts {pl.replicated})"
                 if pl is not None and pl.replicated else ""))

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


def print_profile(args, eng: ServingEngine) -> None:
    """Say where the planner's profile came from: this engine's
    calibration (on a group of several ranks, rank 0's, which every rank
    plans from), or ``--profile``."""
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


def rank_device(args, rank: int):
    """Rank ``rank``'s device: the CPU under ``--device cpu``; else card
    ``rank`` under nccl, and under gloo the cards in turn (ranks share a
    card when there are more ranks than cards)."""
    device = resolve_device(args.device)
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def serve_rank(argv, rank: int, store_dir: str, results) -> None:
    """One rank process of ``serve_ranks``: joins the group over the
    ``file://`` store in ``store_dir``, serves ``argv``'s requests in
    lock step with the other ranks, prints the summary on rank 0, and
    puts (rank, every request's tokens) on ``results``."""
    args = build_parser().parse_args(argv)
    device = rank_device(args, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if args.backend == "nccl":
            # ranks of one host need no interface but the loopback
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    groups = DepGroups.from_file_store(store_dir, rank, args.dp_size,
                                       args.ep_size, args.backend)
    try:
        eng = build_engine(args, groups=groups, device=device)
        if rank == 0:
            print_profile(args, eng)
        served = serve(args, eng)
        if rank == 0:
            print(f"ranks: {args.dp_size} data x {args.ep_size} expert over "
                  f"{args.backend}, {eng.cfg.moe.num_experts // args.ep_size}"
                  " experts a rank")
            report(args, served)
        eng.close()
        results.put((rank, [r.output for r in served.requests]))
    finally:
        torch.distributed.destroy_process_group()


def serve_ranks(args, argv) -> List[List[int]]:
    """Serve on ``args.dp_size`` x ``args.ep_size`` ranks: one spawned
    process per rank (CUDA may already be initialized here), over a
    ``file://`` store in a temporary directory. Raises when a rank
    fails, when nccl has fewer cards than ranks, or when the ranks'
    tokens differ; returns the requests' tokens."""
    world = args.dp_size * args.ep_size
    if args.backend is None:
        raise ValueError("--ep-size/--dp-size need --backend nccl or gloo")
    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if args.backend == "nccl" and cards < world:
        raise ValueError(f"--backend nccl needs a card per rank: {world} "
                         f"ranks, {cards} card(s); --backend gloo shares "
                         "them")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory(prefix="serve-moe-") as store_dir:
        procs = [ctx.Process(target=serve_rank,
                             args=(argv, r, store_dir, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"rank(s) {failed} of {world} failed")
    tokens = dict(results.get() for _ in range(world))
    differ = [r for r in range(world) if tokens[r] != tokens[0]]
    if differ:
        raise RuntimeError(f"ranks {differ} served other tokens than rank 0")
    print(f"all {world} ranks served the same tokens")
    return tokens[0]


def main(argv=None) -> Optional[Served]:
    """Parse ``argv``, serve, print the summary, write the outputs, and
    return what was served (the engine, the requests, the wall time);
    under --ep-size/--dp-size the ranks serve in processes of their own
    and nothing is returned."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.ep_size * args.dp_size > 1:
        serve_ranks(args, argv)
        return None
    eng = build_engine(args)
    print_profile(args, eng)
    served = serve(args, eng)
    report(args, served)
    return served


if __name__ == "__main__":
    main()
