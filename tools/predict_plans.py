#!/usr/bin/env python3
"""Plans the FinDEP planner solves for the full qwen2-moe-a2.7b, on the
CPU (planning needs no card): on ``PAPER_A6000``, and on guessed H100
profiles whose GEMM alpha and beta vary (attention alpha 5 us, beta
3e-15; decode beta 4.5e-13; comm copy-proxy beta 7e-13), at the prefill
(bucket, batch) shapes and decode occupancies of chip_smoke's dep serve.
It writes down a prediction before a chip run measures the card's own
profile; with ``--profile-store DIR --profile NAME`` it solves on a
stored profile instead of the guesses.

Run from the repository root:  python3 tools/predict_plans.py
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import DepClusterConfig  # noqa: E402
from repro_torch.core.perf_model import (PAPER_A6000, AlphaBeta,  # noqa: E402
                                         HardwareProfile)
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig  # noqa: E402
from repro_torch.profiling import ProfileStore  # noqa: E402
from repro_torch.sched import (FinDEPPolicy, OccupancySummary,  # noqa: E402
                               PlanCache)

PREFILL = ((64, 1), (128, 1), (256, 2), (512, 2), (1024, 2), (512, 3),
           (512, 8), (1024, 1))
DECODE = ([300] * 8, [64, 128, 256, 512, 600, 700, 800, 900], [600] * 4,
          [100] * 2, [1000])


def guesses():
    for alpha in (1e-6, 3e-6, 10e-6, 20e-6):
        for beta in (2.5e-15, 4e-15):
            yield HardwareProfile(
                f"h100_guess_gemm_{alpha:g}_{beta:g}",
                gemm=AlphaBeta(alpha, beta), attn=AlphaBeta(5e-6, 3e-15),
                comm=AlphaBeta(2e-6, 7e-13), decode=AlphaBeta(5e-6, 4.5e-13))


def show(cfg, hw) -> None:
    cache = PlanCache(FinDEPPolicy(FinDEPPlanner(
        cfg, DepClusterConfig(8, 3, 5), hw, PlannerConfig(mem_cap_samples=8))))
    keys = [("prefill", b, n, None) for b, n in PREFILL] + [
        ("decode", None, None, OccupancySummary.from_lengths(lens))
        for lens in DECODE]
    for phase, bucket, batch, occ in keys:
        p = cache.get(phase, bucket, batch, occupancy=occ)
        shape = f"{bucket}x{batch}" if occ is None else repr(occ)
        print(f"[{hw.name}] {phase} {shape}: m_a={p.m_a} r1={p.r1} "
              f"m_e={p.m_e:g} r2={p.r2} {p.order} makespan "
              f"{p.makespan * 1e3:.4f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-store", default=None)
    ap.add_argument("--profile", default=None)
    args = ap.parse_args(argv)
    cfg = get_config("qwen2-moe-a2.7b")
    profiles = ([ProfileStore(args.profile_store).load_profile(args.profile)]
                if args.profile else list(guesses()))
    for hw in [PAPER_A6000] + profiles:
        show(cfg, hw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
