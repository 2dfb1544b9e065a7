"""Quickstart: FinDEP end to end in two minutes (the PyTorch counterpart
of ``examples/quickstart.py``, with the same steps and printed lines).

1. Pick an MoE backbone (DeepSeek-V2 style, with shared experts).
2. Calibrate/choose a hardware profile and build the planner.
3. Solve the fine-grained schedule (m_a, r1, m_e, r2, order) — Alg. 1.
4. Compare against naive DEP and best-configured PPPipe.
5. Run the reduced model with the solved schedule. On one device, as
   the reference without a mesh, ``make_model`` picks the capacity MoE
   and the plan has no effect (on the card its experts run through the
   f32 SIMT expert-GEMM kernel, one launch per MoE layer; the default
   ``attn_impl="xla"`` runs no flash kernel). With several cards, a mesh
   of ``min(2, n)`` ranks, one spawned process each over NCCL, runs DEP
   and the solved plan goes with the call (``Model.forward(plan=)``).

Steps 1-4 are the port's copy of the planning layer: host code that
gives the same plan on any device.

Flags of the port's own:

  --device DEV     where step 5 runs (default: the CUDA card; "cpu" for
                   the plain versions)

Run:  python -m repro_torch.launch.quickstart --device cpu
(with ``src`` on ``PYTHONPATH``).
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import tempfile
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import generator_for, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import DepClusterConfig
from repro_torch.core import (FinDEPPlanner, PAPER_A6000, best_pppipe,
                              naive_plan)
from repro_torch.core.planner import PlannerConfig
from repro_torch.launch.steps import make_model

#: the model step 5 executes
SMOKE_ARCH = "deepseek-v2-lite"


@dataclass
class Executed:
    """Step 5's outcome: the logits [2, 64, V] (f32), the aux loss, the
    device, the number of ranks and the model's MoE path."""
    logits: torch.Tensor
    aux: float
    device: torch.device
    devices: int
    moe_impl: str


@dataclass
class Quickstart:
    """What ``main`` printed: the FinDEP plan, the two baselines and step
    5's outcome."""
    plan: object
    pppipe: object
    naive: object
    executed: Executed


def execute(plan, device=None, params=None, tokens=None,
            mesh=None) -> Executed:
    """Step 5: the reduced ``deepseek-v2-lite`` at f32 on ``device``
    (None: the card), forward over 2 x 64 tokens. ``params`` default to
    a draw from seed 0 on the device (on a mesh, the rank's expert
    shard), ``tokens`` to a draw from seed 1 on the CPU. Without a
    ``mesh`` the model is the capacity MoE and ``plan`` is not used, as
    in the reference; with one (a ``launch.mesh.make_host_mesh``), DEP
    runs the plan."""
    smoke = get_smoke_config(SMOKE_ARCH)
    model = make_model(smoke, mesh, dtype=torch.float32, device=device)
    if params is None:
        groups = model.ctx.groups
        shard = (None if groups is None
                 else (groups.expert_rank, groups.expert_size))
        params = model.init(generator_for(model.device, 0),
                            expert_shard=shard)
    if tokens is None:
        tokens = torch.randint(0, smoke.vocab_size, (2, 64),
                               generator=generator_for(torch.device("cpu"),
                                                       1))
    logits, aux = model.forward(params, tokens.to(model.device),
                                plan=plan if mesh is not None else None)
    n = 1 if mesh is None else mesh.size()
    return Executed(logits, float(aux), model.device, n, model.ctx.moe_impl)


def _rank(rank: int, world: int, store: str, plan, backend: str,
          results) -> None:
    """One rank of step 5 on a (1, ``world``) mesh: its card under NCCL,
    the CPU under gloo. Rank 0 puts its outcome, on the CPU, in
    ``results``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    device = "cpu"
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = execute(plan, device, mesh=make_host_mesh(model=world))
        if rank == 0:
            results.put(Executed(out.logits.cpu(), out.aux,
                                 torch.device(device), out.devices,
                                 out.moe_impl))
    finally:
        dist.destroy_process_group()


def execute_on_ranks(plan, world: int, backend: str = "nccl") -> Executed:
    """Step 5 with DEP over ``world`` spawned rank processes (one card
    each under NCCL; CPU processes under gloo), over a ``file://`` store
    in a temporary directory. Returns rank 0's outcome."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(r, world, store, plan,
                                                 backend, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            out = results.get(timeout=600)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
    bad = [p.exitcode for p in procs if p.exitcode]
    if bad:
        raise RuntimeError(f"a rank of step 5 exited with {bad}")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain "
                         "versions")
    return ap


def make_planner() -> FinDEPPlanner:
    """Steps 1-2: deepseek-v2-lite on the paper's 3 + 5 devices, priced
    by the paper's A6000 profile, with an 8-sample memory cap."""
    cfg = get_config("deepseek-v2-lite")
    cluster = DepClusterConfig(num_devices=8, ag=3, eg=5)
    return FinDEPPlanner(cfg, cluster, PAPER_A6000,
                         PlannerConfig(mem_cap_samples=8))


def main(argv: Optional[list] = None) -> Quickstart:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # ---- 1-2: model + cluster + hardware profile -------------------------
    planner = make_planner()
    cfg = planner.model_cfg

    # ---- 3: solve ----------------------------------------------------------
    plan = planner.plan(seq_len=4096)
    print(f"FinDEP plan: m_a={plan.m_a} r1={plan.r1} m_e={plan.m_e:.0f} "
          f"r2={plan.r2} order={plan.order}")
    print(f"  solve time: {planner.last_solve_time*1e3:.1f} ms "
          f"(paper claim: < 1 s)")
    print(f"  predicted throughput: {plan.throughput:.0f} tokens/s")

    # ---- 4: baselines --------------------------------------------------------
    models = planner.stage_models(4096)
    T = len(cfg.moe_layer_indices())
    pp = best_pppipe(models, T, 8, r1_cap=8)
    nv = naive_plan(models, T, 8)
    print(f"\nbest PPPipe:  {pp.throughput:.0f} tokens/s "
          f"(FinDEP speedup {plan.throughput/pp.throughput:.3f}x)")
    print(f"naive DEP:    {nv.throughput:.0f} tokens/s "
          f"(FinDEP speedup {plan.throughput/nv.throughput:.3f}x)")

    # ---- 5: execute the schedule for real ------------------------------------
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_dev > 1:
        out = execute_on_ranks(plan, min(2, n_dev))
    else:
        out = execute(plan, device)
    print(f"\nexecuted reduced model with the solved schedule: "
          f"logits {tuple(out.logits.shape)}, aux loss {out.aux:.4f}, "
          f"devices={n_dev}, device={out.device}, moe_impl={out.moe_impl}")
    return Quickstart(plan, pp, nv, out)


if __name__ == "__main__":
    main()
