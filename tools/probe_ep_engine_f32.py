#!/usr/bin/env python3
"""chip_smoke's f32 ep check with its routings laid open: the one-rank
engine and an expert group of two gloo ranks sharing the card
(qwen2-moe-a2.7b at full width, ``--layers`` of its 24, capacity factor
E / top_k, f32 weights from seed 0) take chip_smoke's 11
teacher-forced steps (``forced_logits`` over ``forced_prompts``), while
every MoE layer's input and routing are kept.

It prints, per model call, the largest router-probability difference
of any layer and the tokens routed to another set of experts than one
rank routes them to (with the least k-th to (k+1)-th probability gap
among them, and the layer), and each step's relative L2 of the logits,
the figure chip_smoke holds to ``EP_LOGIT_TOL[torch.float32]``.

Run from the repository root, on one card:
    python3 tools/probe_ep_engine_f32.py
(``--device cpu`` runs it at smoke size on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.dep import DepGroups  # noqa: E402
from repro_torch.runtime import ServingEngine  # noqa: E402


def config(args):
    cfg = (get_config if args.device == "cuda" else get_smoke_config)(
        "qwen2-moe-a2.7b")
    return dataclasses.replace(cs.no_drop(cfg), num_layers=args.layers)


def run(args, groups=None) -> dict:
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    cfg = config(args)
    eng = ServingEngine(cfg, num_slots=8, max_context=1024,
                        dtype=torch.float32, device=device, seed=0,
                        ep_group=groups, decode_graph=False,
                        track_expert_load=True)
    with cs.MoeRecord() as rec:
        logits = cs.forced_logits(eng, cfg, cs.forced_prompts(cfg.vocab_size))
    return {"inputs": rec.shapes, "probs": rec.probs,
            "experts": rec.experts, "logits": logits,
            "dropped": eng.stats.dropped_tokens}


def rank(r: int, store: str, args) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cuda":
        torch.cuda.set_device(0)
    groups = DepGroups.from_file_store(os.path.join(store, "store"), r, 1, 2,
                                       "gloo")
    with torch.no_grad():
        out = run(args, groups)
    torch.save(out, os.path.join(store, f"rank{r}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--layers", type=int, default=cs.EP_F32_LAYERS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_ep_engine_f32: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        want = run(args)
    if args.device == "cuda":
        torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="probe-ep-engine-") as store:
        procs = [ctx.Process(target=rank, args=(r, store, args))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with {p.exitcode}")
        got = [torch.load(os.path.join(store, f"rank{r}.pt"))
               for r in range(2)]
    k = config(args).moe.top_k
    L = args.layers
    calls = len(want["inputs"]) // L
    total = 0
    for c in range(calls):
        worst, flips, notes = 0.0, 0, []
        for layer in range(L):
            i = c * L + layer
            B, S, _ = want["inputs"][i]
            full_p = want["probs"][i].view(B, S, -1)
            full_e = want["experts"][i].view(B, S, k)
            split = got[0]["inputs"][i] == want["inputs"][i] and \
                got[0]["probs"][i].shape[0] < B * S
            for r in range(2):
                if split:
                    mine = slice(r * (S // 2), (r + 1) * (S // 2))
                    rows = S // 2
                else:
                    mine, rows = slice(0, S), S
                p = got[r]["probs"][i].view(B, rows, -1)
                e = got[r]["experts"][i].view(B, rows, k)
                worst = max(worst, float((p - full_p[:, mine]).abs().max()))
                same = (e.sort(-1).values
                        == full_e[:, mine].sort(-1).values).all(-1)
                n = int((~same).sum())
                if n:
                    top = full_p[:, mine].topk(k + 1, dim=-1).values
                    gap = float((top[..., k - 1] - top[..., k])[~same].min())
                    notes.append(f"layer {layer}: {n} (gap {gap:.2e})")
                flips += n
        total += flips
        print(f"[probe ep engine f32] call {c} ({B} x {S}): router probs "
              f"max |d| {worst:.3e}; {flips} tokens rerouted"
              + (f" ({'; '.join(notes)})" if notes else ""))
    err = cs.logit_error(got[0]["logits"], want["logits"])
    print(f"[probe ep engine f32] {args.layers} layers: per step relative "
          f"L2 {err[2]}, worst {err[0]:.3e}; {total} reroutings; dropped "
          f"{want['dropped']}, {got[0]['dropped']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
