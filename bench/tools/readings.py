"""The readings a cell's check limit is set from, several seeds in one
process: each seed's run at the cell's own load (a shorter window), the
program's mean and widest gap, and the fp8 control's on the same
prompts and served tokens.

    python3 bench/tools/readings.py --workload <cell> --seconds S --seeds a,b,c [--control 0|1]

One JSON line per seed (seed, program, control, tokens and requests
compared, window steps), with each mean gap put through the check's own
``check.verdict`` at the cell's committed limit: ``program_correct``
must read true and ``control_correct`` false. The runs' set-up is not
timed here.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def reading_line(workload: str, seed: int, seconds: float, limit,
                 control: bool = True, **run_kw):
    """One seed's readings: the run at the cell's load, the program's gap
    and, with ``control``, the fp8 control's on the same tokens, each put
    through ``check.verdict`` at ``limit``. ``run_kw`` goes to
    ``harness.run_cell`` (the CPU tests' smoke sizes)."""
    from bench import check, harness
    t = time.perf_counter()
    run, rd = harness.run_cell(workload, seed, seconds, False, t,
                               control=control, **run_kw)
    low = rd.get("control")
    return {"seed": seed, "program": run.gap, "control": low,
            "limit": limit,
            "program_correct": check.verdict(
                (run.gap or {}).get("mean"), limit, run.checked_tokens),
            "control_correct": (None if low is None else
                                check.verdict(low["mean"], limit,
                                              run.checked_tokens)),
            "tokens": run.checked_tokens, "requests": run.checked_requests,
            "wall_s": time.perf_counter() - t, **run.engine_info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args(argv)
    from bench import harness
    limit = harness.limits(args.workload).get("mean_logit_gap",
                                              {}).get("limit")
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = reading_line(args.workload, seed, args.seconds, limit,
                            bool(args.control))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
