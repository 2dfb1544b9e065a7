#!/usr/bin/env python3
"""Rehearse chip_smoke.py's calibrate and serve phases on the CPU, at
smoke size.

The calibrate, serve, paged, pressure, dep, drift, obs, xlstm and hybrid
phases run as on the card, with the smoke configs in place of the full
ones (the obs phase's entry point too), every engine on the CPU, the
calibration on the CPU at f32 over the reference's sweeps (the plain
versions in place of the kernels), and the dep and obs phases' expert
group on gloo (one rank). An engine
that would capture its decode step gets ``EagerGraph``,
a stand-in for ``decode_graph.CudaGraph`` whose replay runs the captured
step again and copies its outputs into the captured ones, so that the
graph path's bookkeeping (one warm-up before the serve, one capture per
key, a replay per step, launches added per replay)
and chip_smoke's checks of it run. The kernel wrappers count their CPU
calls here, as their CUDA calls count on the card; the profiles and
timings are skipped (they read device time; a skipped decode profile
reports the card's host calls per graph step, 1 ``cudaGraphLaunch`` and
2 ``cudaLaunchKernel``, so that the checks after it run). The obs
phase's layer trace takes the host clock (no CUDA events on the CPU).
This finds wrong paths,
shapes and checks before a chip call; it measures nothing.

Run from the repository root:  python3 tools/rehearse_chip_smoke.py
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.rg_lru import ops as rglru_ops  # noqa: E402
from repro_torch.launch import serve_moe  # noqa: E402
from repro_torch.models import moe, rglru, ssm  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402
from repro_torch.runtime.decode_graph import DecodeGraphs  # noqa: E402


class EagerGraph:
    """Stands in for ``CudaGraph``: its capture runs the step (a real
    capture only records it, and the replay after it runs it), so the
    replay right after a capture does nothing; later replays run the step
    again and copy its outputs into the captured ones. A replay's own
    launches are taken back out of the counts: the runner adds the
    captured ones."""

    def capture(self, fn):
        self.fn, self.fresh = fn, True
        self.outputs = fn()
        return self.outputs

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        before = kernels.launch_counts()
        new = self.fn()
        after = kernels.launch_counts()
        kernels.add_launch_counts({k: before[k] - after[k] for k in after})
        for out, value in zip(self.outputs, new):
            out.copy_(value)


def engine(*args, decode_graph=None, **kwargs):
    """A CPU engine; unless ``decode_graph=False``, with stand-in graphs."""
    kwargs["device"] = "cpu"
    eng = ServingEngine(*args, **kwargs)
    if decode_graph is not False:
        eng.decode_graph = True
        eng._graphs = DecodeGraphs(eng._step, EagerGraph, eng.stats)
    return eng


def counting(module, name):
    """Make CPU calls of ``module.name`` count as launches."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        wrapper.launches += 1
        return fn(*args, **kw)

    wrapper.launches = 0
    setattr(module, name, wrapper)
    return wrapper


def main() -> int:
    torch.manual_seed(0)
    for module, name in ((dec_ops, "decode_attention"),
                         (dec_ops, "decode_attention_paged"),
                         (flash_ops, "flash_attention")):
        counting(module, name)
    for ops_module, model_module, name in (
            (gemm_ops, moe, "moe_gemm"), (mlstm_ops, ssm, "mlstm_scan"),
            (rglru_ops, rglru, "rg_lru_scan")):
        setattr(model_module, name, counting(ops_module, name))
    chip_smoke.get_config = serve_moe.get_config = get_smoke_config
    chip_smoke.ServingEngine = serve_moe.ServingEngine = engine
    chip_smoke.profile_decode = lambda *a, **k: {"cudaGraphLaunch": 1,
                                                 "cudaLaunchKernel": 2}
    chip_smoke.profile_prefill = lambda *a, **k: None
    chip_smoke.time_dep_chunks = lambda *a, **k: None
    chip_smoke.time_dep_alltoall = lambda *a, **k: None
    chip_smoke.DEP_BACKEND = "gloo"
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.memory_allocated = lambda *a, **k: 0
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.max_memory_reserved = lambda *a, **k: 0
    chip_smoke.CAL_DEVICE = chip_smoke.OBS_DEVICE = "cpu"
    chip_smoke.CAL_DTYPE = torch.float32
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, ".repro-profiles"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, ".repro-profiles")) as store_dir:
        profile, _ = chip_smoke.phase_calibrate(store_dir)
        chip_smoke.phase_serve()
        chip_smoke.phase_serve_dep(profile, store_dir)
        chip_smoke.phase_obs(profile, store_dir)
        torch.distributed.destroy_process_group()
        chip_smoke.phase_serve_xlstm()
        chip_smoke.phase_serve_hybrid()
    print(f"rehearsal: the calibrate phase and every serve phase passed on "
          f"the CPU in "
          f"{time.perf_counter() - t0:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
