"""Multi-pod dry run of the port (the counterpart of
``repro.launch.dryrun``).

For every (architecture x input shape) the step is built against the
production mesh, 16x16 ("data", "model") single-pod or 2x16x16 ("pod",
"data", "model") multi-pod, on a fake process group of 256 or 512 ranks
in this one process (``launch.mesh.make_production_mesh``), and rank 0's
step runs on ``meta`` tensors under a ``roofline.StepCounter``. Nothing
is allocated and no card is touched: the dry run runs anywhere, on a
host without a GPU too. Failures here are sharding bugs.

Accounting: the reference compiles the deployable program for its memory
figures and two reduced-depth probes for its counts, because XLA counts
a ``While`` body once. The port's step runs eagerly, one op at a time,
so one meta run at full depth gives both: the rank's argument bytes from
its shards by the specs, the peak of what the step allocates, the FLOPs
and HBM bytes of every op and kernel call, and the wire bytes of every
collective, against the H100 constants of ``roofline``. Prefill and
decode run the serving kernels (``attn_impl="decode_kernel"``: flash at
prefill, the ragged decode kernel, the expert GEMM); train runs
``attn_impl="xla"``, the one the port trains under. A decode step on
``meta`` counts every row at the cache's full capacity (its lengths are
not known).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-moe-a2.7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback


def rank_args(bundle, mesh):
    """Rank 0's arguments of a sharded bundle as ``meta`` tensors: its
    parameter (and optimizer-state) shards, as DTensors where the step
    takes DTensors (train), the GLOBAL inputs (the step takes each rank's
    rows itself) and its cache shards."""
    from repro_torch.launch import steps
    from repro_torch.training.tree import tree_leaves, tree_unflatten
    args, pls = list(bundle.abstract_args), bundle.placements
    if not bundle.name.endswith(":train"):
        out = [steps.local_abstract(args[0], pls[0], mesh)] + args[1:]
        if bundle.name.endswith(":decode"):
            out[2] = steps.local_abstract(args[2], pls[2], mesh)
        return out
    from torch.distributed.tensor import DTensor

    def dt(glob, pl):
        loc = steps.local_abstract(glob, pl, mesh)
        return tree_unflatten(glob, [
            DTensor.from_local(x, mesh, p, run_check=False, shape=g.shape,
                               stride=g.stride())
            for x, g, p in zip(tree_leaves(loc), tree_leaves(glob),
                               tree_leaves(pl, tuple))])
    opt = args[1]
    return [dt(args[0], pls[0]),
            type(opt)(step=opt.step, mu=dt(opt.mu, pls[1].mu),
                      nu=dt(opt.nu, pls[1].nu))] + args[2:]


def count_step(bundle, mesh):
    """(counts, seconds) of rank 0's step of ``bundle`` on ``meta``."""
    import torch
    from repro_torch.roofline import StepCounter
    args = rank_args(bundle, mesh)
    t0 = time.perf_counter()
    with torch.no_grad() if not bundle.name.endswith(":train") \
            else torch.enable_grad(), StepCounter() as c:
        bundle.step_fn(*args)
    return c.counts, time.perf_counter() - t0


def build_bundle(arch: str, shape_name: str, mesh, plan=None):
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import steps
    shape = get_shape(shape_name)
    cfg = steps.adapt_for_shape(get_config(arch), shape)
    impl = "xla" if shape.mode == "train" else "decode_kernel"
    return cfg, shape, steps.build(cfg, shape, mesh, dtype=torch.bfloat16,
                                   attn_impl=impl, device="meta", plan=plan)


def _plan(cfg, shape, mesh, policy, profile, profile_store):
    if policy is None:
        return None
    from repro_torch.launch import steps
    return steps.resolve_launch_plan(
        cfg, mesh, policy, shape.seq_len, mode=shape.mode,
        batch_per_device=shape.global_batch
        // steps._data_parallel(shape.global_batch, mesh),
        profile=profile, profile_store=profile_store)


def count_fields(cfg, shape, counts, chips: int) -> dict:
    """The record's count-derived fields (``recount_one`` re-derives only
    these)."""
    from repro_torch import roofline
    r = roofline.analyze(f"{cfg.name}:{shape.name}", counts,
                         roofline.model_flops(cfg, shape), chips)
    return {
        "flops_per_device": counts.flops,
        "flops_by_dtype": dict(counts.flops_by_dtype),
        "hbm_bytes_per_device": counts.hbm_bytes,
        "collective_bytes_per_device": counts.collective_wire_bytes,
        "collective_counts": dict(counts.collective_counts),
        "collective_bytes_by_kind": dict(counts.collective_bytes),
        "kernel_work": {k: dict(v) for k, v in counts.kernels.items()},
        "compute_ms": round(r.compute_s * 1e3, 3),
        "memory_ms": round(r.memory_s * 1e3, 3),
        "collective_ms": round(r.collective_s * 1e3, 3),
        "dominant": r.dominant,
        "model_flops": r.model_flops,
        "useful_flops_ratio": round(r.useful_ratio, 4),
    }


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            verbose: bool = True, policy=None, profile=None,
            profile_store=None) -> dict:
    """The dry-run record of one (arch x shape) on the production mesh:
    the reference's keys (``lower_s`` and ``compile_s`` dropped,
    ``count_s`` added: the meta run's wall time). ``policy`` plans the
    MoE layers through ``resolve_launch_plan`` (``profile`` the hardware
    fit to plan against)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    shape = get_shape(shape_name)
    plan = _plan(steps.adapt_for_shape(get_config(arch), shape), shape,
                 mesh, policy, profile, profile_store)
    cfg, shape, bundle = build_bundle(arch, shape_name, mesh, plan)
    counts, count_s = count_step(bundle, mesh)
    args_b = steps.arg_bytes(bundle, mesh)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "mode": shape.mode,
        "ok": True,
        "count_s": round(count_s, 2),
        "accum_steps": bundle.accum_steps,
        "arg_bytes_per_device": args_b,
        "temp_bytes_per_device": counts.peak_live_bytes,
        "peak_gb_per_device": round((args_b + counts.peak_live_bytes) / 1e9,
                                    3),
    }
    rec.update(count_fields(cfg, shape, counts, chips))
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: OK "
              f"(count {count_s:.1f}s, accum={bundle.accum_steps})")
        print(f"  memory/device: args={args_b / 1e9:.2f}GB "
              f"temp={counts.peak_live_bytes / 1e9:.2f}GB "
              f"peak={rec['peak_gb_per_device']:.2f}GB")
        print(f"  roofline (H100 SXM published peaks): "
              f"compute={rec['compute_ms']}ms memory={rec['memory_ms']}ms "
              f"collective={rec['collective_ms']}ms "
              f"dominant={rec['dominant']} "
              f"useful={rec['useful_flops_ratio']:.3f}")
        print(f"  collectives: "
              f"{ {k: int(v) for k, v in rec['collective_counts'].items()} }")
    return rec


def grid(multi_pod: bool, archs=None, shapes=None, json_path=None,
         stop_on_fail: bool = False, policy=None, profile=None,
         profile_store=None):
    from repro_torch.configs import ASSIGNED_ARCHS, SHAPES
    archs = archs or list(ASSIGNED_ARCHS)
    shapes = shapes or list(SHAPES)
    results = []
    for arch in archs:
        for shape in shapes:
            try:
                results.append(run_one(arch, shape, multi_pod,
                                       policy=policy, profile=profile,
                                       profile_store=profile_store))
            except Exception as e:
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                 "mesh": "2x16x16" if multi_pod else "16x16",
                                 "ok": False,
                                 "error": f"{type(e).__name__}: {e}"})
                if stop_on_fail:
                    break
            if json_path:
                with open(json_path, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"[dryrun] {n_ok}/{len(results)} combinations counted")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--policy", default=None,
                    help="schedule by policy name (findep | static | "
                         "sequential | eps) instead of the unchunked walk")
    ap.add_argument("--profile", default=None,
                    help="hardware profile name to plan against (registry "
                         "or calibrated store; default the reference's "
                         "analytic profile)")
    ap.add_argument("--profile-store", default=".repro-profiles",
                    help="ProfileStore root searched before the registry "
                         "when --profile is a name")
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if args.all:
        res = grid(args.multi_pod, json_path=args.json, policy=args.policy,
                   profile=args.profile, profile_store=args.profile_store)
        sys.exit(0 if all(r.get("ok") for r in res) else 1)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    rec = run_one(args.arch, args.shape, args.multi_pod,
                  policy=args.policy, profile=args.profile,
                  profile_store=args.profile_store)
    print(json.dumps(rec))
    if args.json:
        with open(args.json, "w") as f:
            json.dump([rec], f, indent=1)


if __name__ == "__main__":
    main()
