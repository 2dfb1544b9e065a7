"""CLI gate: ``python -m repro_torch.analysis [--check] [--fast] [-q]
[passes...]``.

Prints every violation and a per-pass summary. ``--check`` exits
non-zero on any violation (the CI gate mode); without it the run is
report-only. ``--fast`` restricts graphcheck's sweep and kernelcheck's
case matrix to representative slices (same properties, smaller budget).
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.analysis import PASSES, run_all


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                description=__doc__)
    p.add_argument("passes", nargs="*", default=[],
                   help=f"passes to run (default all): {', '.join(PASSES)}")
    p.add_argument("--check", action="store_true",
                   help="exit non-zero on violations (CI gate)")
    p.add_argument("--fast", action="store_true",
                   help="representative slice of the sweep/case matrix")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress per-shape progress lines")
    args = p.parse_args(argv)
    passes = tuple(args.passes) or PASSES

    log = None if args.quiet else (lambda m: print(f"  {m}", flush=True))
    t0 = time.perf_counter()
    results, info = run_all(passes, fast=args.fast, log=log)
    elapsed = time.perf_counter() - t0

    total = 0
    for name in passes:
        for v in results[name]:
            print(v)
        total += len(results[name])
        print(f"{name}: {len(results[name])} violation(s)")
    for k, v in sorted(info.items()):
        print(f"# {k} = {v}")
    print(f"# total = {total} violation(s) in {elapsed:.1f}s")
    if total and args.check:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
