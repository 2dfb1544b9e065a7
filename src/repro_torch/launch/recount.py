"""Re-derive the count fields of an existing dry-run JSON (FLOPs, HBM and
collective bytes, the roofline terms and the dominant one) without
touching its memory fields: the counterpart of ``repro.launch.recount``.
The port counts a step with one ``meta`` run at full depth
(``launch.dryrun``), so a recount is that run again: it touches no card.

Usage: python -m repro_torch.launch.recount dryrun_1pod.json [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import traceback


def recount_one(rec: dict, multi_pod: bool) -> dict:
    """``rec`` with its count fields re-derived (``dryrun.count_fields``)
    from a fresh count of its (arch x shape) on the production mesh."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg, shape, bundle = dryrun.build_bundle(rec["arch"], rec["shape"], mesh)
    counts, _ = dryrun.count_step(bundle, mesh)
    rec.update(dryrun.count_fields(cfg, shape, counts, mesh.size()))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("json_path")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    with open(args.json_path) as f:
        recs = json.load(f)
    for i, rec in enumerate(recs):
        if not rec.get("ok"):
            continue
        try:
            recs[i] = recount_one(rec, args.multi_pod)
            print(f"[recount] {rec['arch']} x {rec['shape']}: "
                  f"coll={rec['collective_ms']}ms dom={rec['dominant']}",
                  flush=True)
        except Exception:
            traceback.print_exc()
        with open(args.json_path, "w") as f:
            json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
