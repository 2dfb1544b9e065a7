"""Measure the card's profile once with the port's own calibration and
write it where the benchmark's planner reads it.

    python3 bench/tools/freeze_profile.py [--out DIR] [--name NAME]

``profiling.calibrate`` over the card's sweeps at bfloat16 (2 warm-up and
9 timed calls a sample), the store's JSON under DIR (default
``chiprun_out/profiles``); copy it into ``bench/profiles/`` to freeze it.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profiles"))
    ap.add_argument("--name", default="h100-sxm-bf16")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.profiling import calibrate
    from repro_torch.profiling.store import ProfileKey, ProfileStore
    device = torch.device("cuda", 0)
    key = ProfileKey.for_host(None, torch.bfloat16, device)
    res = calibrate(name=args.name, fast=False, dtype=torch.bfloat16,
                    device=device)
    entry = ProfileStore(args.out).put_calibration(res, key, name=args.name)
    for kind, fit in res.profile.as_dict().items():
        print(kind, fit, "R^2", res.fit_r2.get(kind))
    print(f"{entry.name}: {key} in {res.wall_s:.2f} s -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
