#!/usr/bin/env python3
"""Can two processes on one card form a process group, and which
collectives pass CUDA tensors between them?

Spawns two ranks on ``cuda:0`` over a ``file://`` store in a temporary
directory, once under NCCL (one communicator with two ranks on one card)
and once under gloo, and runs the collectives the sharded engine issues
on bf16 CUDA tensors: ``all_to_all_single`` with even and uneven splits,
``all_gather``, ``all_reduce`` and ``broadcast``. Each rank checks the
values it receives and prints what failed, with the library's own
message. Under gloo it also times ``all_to_all_single`` at a few sizes
(host clock around the call and a synchronize; median of 5).

Run on a machine with one card:  python3 tools/probe_two_ranks_one_card.py
"""
from __future__ import annotations

import multiprocessing
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

SIZES_MB = (1, 16, 64, 256)


def _check(name, got, want):
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: received values differ")
    print(f"  rank {dist.get_rank()}: {name} ok", flush=True)


def _collectives(rank: int, backend: str) -> None:
    dev = torch.device("cuda", 0)
    x = torch.full((4, 8), float(rank + 1), dtype=torch.bfloat16,
                   device=dev)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    want = torch.cat([torch.full((2, 8), float(r + 1), dtype=torch.bfloat16,
                                 device=dev) for r in range(2)])
    _check("all_to_all_single (even)", out, want)
    # uneven: rank 0 sends 1 row to itself and 3 to rank 1; rank 1 sends
    # 3 to rank 0 and 1 to itself
    ins = [1, 3] if rank == 0 else [3, 1]
    outs = [1, 3] if rank == 0 else [3, 1]
    out = torch.empty((sum(outs), 8), dtype=torch.bfloat16, device=dev)
    dist.all_to_all_single(out, x, outs, ins)
    want = torch.cat([torch.full((outs[r], 8), float(r + 1),
                                 dtype=torch.bfloat16, device=dev)
                      for r in range(2)])
    _check("all_to_all_single (uneven splits)", out, want)
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    _check("all_gather", torch.stack(parts), torch.stack(
        [torch.full_like(x, float(r + 1)) for r in range(2)]))
    y = x.clone()
    dist.all_reduce(y)
    _check("all_reduce", y, torch.full_like(x, 3.0))
    y = x.clone()
    dist.broadcast(y, src=1)
    _check("broadcast", y, torch.full_like(x, 2.0))
    if backend != "gloo":
        return
    times = {}
    for mb in SIZES_MB:
        n = mb * 2 ** 20 // 2
        send = torch.zeros(n, dtype=torch.bfloat16, device=dev)
        recv = torch.empty_like(send)
        samples = []
        for _ in range(6):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_to_all_single(recv, send)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        times[mb] = sorted(samples[1:])[2]
    print(f"  rank {rank}: gloo all_to_all_single of bf16 CUDA tensors, "
          f"MB sent per rank: median ms of 5 {times}", flush=True)


def _rank(rank: int, backend: str, store: str) -> None:
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}/store", rank=rank,
            world_size=2,
            device_id=torch.device("cuda", 0) if backend == "nccl"
            else None)
        _collectives(rank, backend)
        dist.barrier()
        dist.destroy_process_group()
    except Exception as e:                      # report, then fail the rank
        print(f"  rank {rank} under {backend}: {type(e).__name__}: "
              f"{str(e)[:600]}", flush=True)
        traceback.print_exc(limit=2)
        sys.stdout.flush()
        os._exit(1)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{torch.cuda.nccl.version()}", flush=True)
    ctx = multiprocessing.get_context("spawn")
    verdict = {}
    for backend in ("nccl", "gloo"):
        print(f"[{backend}] two ranks on cuda:0", flush=True)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        with tempfile.TemporaryDirectory() as store:
            procs = [ctx.Process(target=_rank, args=(r, backend, store))
                     for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=120)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in procs]
        verdict[backend] = "passed" if codes == [0, 0] else f"failed {codes}"
        print(f"[{backend}] {verdict[backend]}", flush=True)
    print(f"verdict: {verdict}")
    return 0 if verdict["gloo"] == "passed" else 1


if __name__ == "__main__":
    sys.exit(main())
