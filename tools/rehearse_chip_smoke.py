#!/usr/bin/env python3
"""Rehearse chip_smoke.py's calibrate, serve and train phases on the CPU,
at smoke size.

The calibrate, serve, paged, pressure, dep, drift, placement, obs, mla,
qwen3, ep, xlstm, hybrid, multimodal, long, train and train_recurrent
phases run as on
the card, with the smoke configs
in place of the full ones (the obs phase's entry point too; the qwen3
path's smoke config at its 8 layers), every engine on the CPU, the
calibration on the CPU at f32 over the reference's sweeps (the plain
versions in place of the kernels), the dep, placement and obs phases'
expert group on gloo (one rank), and the ep phase's two ranks as two
spawned CPU processes over gloo, each patched as this process is
(``patch``), its off-by-one-expert control included (the train phase's
two sharded ranks too). The long phase runs the smoke config adapted to
``long_500k`` (its window of 8192 over 2 layers). An engine
that would capture its decode step gets ``EagerGraph``,
a stand-in for ``decode_graph.CudaGraph`` whose replay runs the captured
step again and copies its outputs into the captured ones, so that the
graph path's bookkeeping (one warm-up before the serve, one capture per
key, a replay per step, launches added per replay)
and chip_smoke's checks of it run. The kernel wrappers count their CPU
calls here, as their CUDA calls count on the card; the profiles and
timings are skipped, the MLA recompute's timing and the serve path's
host-sync guard with them (they read
device time; a skipped decode profile
reports the card's host calls per graph step, 1 ``cudaGraphLaunch`` and
2 ``cudaLaunchKernel``, so that the checks after it run). The obs
phase's layer trace takes the host clock (no CUDA events on the CPU).
The train phase holds the expert GEMM's Function at the smoke config's
shape, trains the smoke config cut to 8 layers (the recurrent train
path: the xlstm and recurrentgemma smoke configs at 8 and 6 layers, the
scans' backwards' CPU calls counted as launches) and runs the entry
point's tiny preset for 60 steps of 4 x 64 tokens (its loss must fall
0.2 nat, the reference's own test; on the card the 100m and tiny
presets run 200 steps each). This
finds wrong paths, shapes and checks before a chip call; it measures
nothing.

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


def patch() -> None:
    """Point chip_smoke at the CPU and the smoke configs (also run first
    in each of the ep phase's spawned ranks)."""
    torch.manual_seed(0)
    for module, name in ((dec_ops, "decode_attention"),
                         (dec_ops, "decode_attention_paged"),
                         (flash_ops, "flash_attention")):
        counting(module, name)
    for ops_module, model_module, name in (
            (gemm_ops, moe, "moe_gemm"), (mlstm_ops, ssm, "mlstm_scan"),
            (rglru_ops, rglru, "rg_lru_scan")):
        setattr(model_module, name, counting(ops_module, name))
    # the scans' Functions look their backward wrappers up at call time
    counting(mlstm_ops, "mlstm_scan_backward")
    counting(rglru_ops, "rg_lru_scan_backward")
    chip_smoke.get_config = serve_moe.get_config = get_smoke_config
    chip_smoke.ServingEngine = serve_moe.ServingEngine = engine
    chip_smoke.profile_decode = lambda *a, **k: {
        "cudaGraphLaunch": 1, "cudaLaunchKernel": 2, "cudaMemcpyAsync": 0,
        "cudaStreamSynchronize": 0}
    chip_smoke.profile_prefill = lambda *a, **k: None
    chip_smoke.time_dep_chunks = lambda *a, **k: None
    chip_smoke.time_rep_gemm = lambda *a, **k: None
    chip_smoke.time_dep_alltoall = lambda *a, **k: None
    chip_smoke.time_mla_recompute = lambda *a, **k: {}
    chip_smoke.time_cross_kv = chip_smoke.step_device_ms = \
        lambda *a, **k: 0.0
    chip_smoke.check_sync_guard = lambda *a, **k: None
    chip_smoke.DEP_BACKEND = "gloo"
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.memory_allocated = lambda *a, **k: 0
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.max_memory_reserved = lambda *a, **k: 0
    # the train phase's timings run their calls once and read 0
    chip_smoke.time_ms = lambda fn, *a, **k: (fn(), 0.0)[1]
    chip_smoke.profile_breakdown = lambda fn, *a, **k: (fn(), {"calls": 1})[1]
    chip_smoke.CAL_DEVICE = chip_smoke.OBS_DEVICE = "cpu"
    chip_smoke.EP_DEVICE = chip_smoke.MM_DEVICE = "cpu"
    chip_smoke.TRAIN_DEVICE = chip_smoke.LONG_DEVICE = "cpu"
    # the tiny preset's 60 steps of 4 x 64: the reference's own test asks
    # 0.2 nat
    chip_smoke.TRAIN_LOOP_RUNS = ((["--preset", "tiny", "--steps", "60",
                                    "--batch", "4", "--seq", "64"], 0.2),)
    chip_smoke.CAL_DTYPE = chip_smoke.EP_DTYPE = torch.float32
    chip_smoke.MM_DTYPE = torch.float32


def main() -> int:
    patch()
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, ".repro-profiles"), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, ".repro-profiles")) as store_dir:
        profile, _ = chip_smoke.phase_calibrate(store_dir)
        chip_smoke.phase_serve()
        chip_smoke.phase_serve_dep(profile, store_dir)
        chip_smoke.phase_placement(profile)
        chip_smoke.phase_obs(profile, store_dir)
        for path in ("mla", "qwen3"):
            chip_smoke.phase_backbone(path, profile)
        torch.distributed.destroy_process_group()
        chip_smoke.phase_ep(profile, setup=patch)
        chip_smoke.phase_serve_xlstm()
        chip_smoke.phase_serve_hybrid()
        chip_smoke.phase_multimodal()
        chip_smoke.phase_long()
        chip_smoke.phase_train(setup=patch)
        chip_smoke.phase_train_recurrent()
    print(f"rehearsal: the calibrate phase, every serve phase and the train "
          f"phase passed on the CPU in "
          f"{time.perf_counter() - t0:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
