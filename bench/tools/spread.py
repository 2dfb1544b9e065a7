"""The spread of a cell's runs, by metric and set, and the bound it
suggests.

    python3 bench/tools/spread.py RUNS.jsonl [...]

Each line of a RUNS file is ``{"tag": ..., "seed": ..., "trace": ...,
"rc": ..., "result": <the run's result line>}``. For each tag (a set of
runs) and metric: the median, the quartiles of
``statistics.quantiles(values, n=4)``, and the spread, the distance
between them as a share of the median; then, over the sets named
``set1`` and ``set2``, the wider spread of each metric and five times
it (the bound the benchmark's rules suggest, at least 1%), and the
check's reading for tightness: the mean of the two sets' spreads, each
set without its run farthest from its median.
"""
import json
import statistics
import sys
from collections import defaultdict


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return med, q1, q3, (q3 - q1) / abs(med) if med else float("nan")


def main(paths) -> int:
    by = defaultdict(lambda: defaultdict(list))
    for path in paths:
        for line in open(path):
            d = json.loads(line)
            r = d.get("result") or {}
            ok = d["rc"] == 0 and r.get("correct")
            print(f"{d['tag']:7s} seed {d['seed']} trace {d['trace']} "
                  f"rc {d['rc']} correct {r.get('correct')} "
                  f"{r.get('checks', {})}")
            if d["rc"] != 0:
                continue
            for name, m in r.get("metrics", {}).items():
                by[d["tag"]][name].append(m["value"])
            by[d["tag"]]["memory_peak_gb"].append(
                r["device"]["memory_peak_bytes"] / 1e9)
            if not ok:
                print("  ^ not correct")
    widest = defaultdict(float)
    trimmed = defaultdict(list)
    for tag, metrics in by.items():
        for name, vals in sorted(metrics.items()):
            if len(vals) < 2:
                print(f"{tag:7s} {name}: {vals}")
                continue
            med, q1, q3, s = spread(vals)
            print(f"{tag:7s} {name}: n {len(vals)} median {med:.6g} "
                  f"q1 {q1:.6g} q3 {q3:.6g} spread {s:.4%} "
                  f"values {[round(v, 4) for v in vals]}")
            if tag in ("set1", "set2"):
                widest[name] = max(widest[name], s)
                if len(vals) >= 4:
                    far = max(vals, key=lambda v: abs(v - med))
                    rest = list(vals)
                    rest.remove(far)
                    trimmed[name].append(spread(rest)[3])
    for name, s in sorted(widest.items()):
        t = trimmed.get(name)
        tight = f", trimmed mean {statistics.mean(t):.4%}" if t else ""
        print(f"widest {name}: {s:.4%} -> bound {max(5 * s, 0.01):.4f}"
              f"{tight}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
