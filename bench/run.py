"""Run one cell of the port's benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the chips the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each number the check
compared beside its limit, which also end standard error. Without
enough CUDA devices, or if the process holds JAX or the JAX reference
package once the window has closed, it prints no result and exits
non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run at a fixed place in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench-cache" / sub)
# the dropless prefill's expert buffers come and go in several GiB at a
# time: grow segments in place rather than fragment the card
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import repro_torch  # noqa: F401  (the program under test; a checkout
    # without it ends here, before any device is touched)
    from bench import check, harness
    bench = harness.load_benchmark()
    cell, _, _, _ = harness.cell_files(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run, _ = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {bad}: the benchmark runs the port "
              "alone", file=sys.stderr)
        return 4
    limit = harness.limits(args.workload).get("mean_logit_gap",
                                              {}).get("limit")
    gap = run.gap or {}
    attempted, failed = harness.counts(run.window)
    result = {"correct": check.verdict(gap.get("mean"), limit,
                                       run.checked_tokens),
              "attempted": attempted, "failed": failed,
              "metrics": harness.metrics_of(run, bench, bool(args.trace)),
              "device": run.device}
    tr = run.window.trace
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["info"] = dict(run.engine_info,
                          widest_logit_gap=gap.get("widest"),
                          requests_compared=run.checked_requests)
    # the last key: each number compared beside its limit (the mean gap at
    # most its limit, the tokens compared at least theirs)
    checks = {"mean_logit_gap": {"value": gap.get("mean"), "limit": limit},
              "served_tokens_compared": {"value": run.checked_tokens,
                                         "limit": 1}}
    result["checks"] = checks
    print(f"check mean_logit_gap: {checks['mean_logit_gap']['value']} "
          f"(at most {limit})", file=sys.stderr)
    print(f"check served_tokens_compared: {run.checked_tokens} (at least 1)",
          file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
