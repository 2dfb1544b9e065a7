#!/usr/bin/env python3
"""Where two expert ranks and one part ways in f32: one prefill of
qwen2-moe-a2.7b at full width (``--layers`` of its 24, capacity factor
E / top_k, f32 weights from seed 0) on an expert group of two gloo ranks
sharing the card, against the one-rank capacity path on the same
weights and tokens.

Per MoE layer it prints the layer input's difference (max |d| over max
|x|), the router probabilities' largest difference, and how many tokens
route to another set of experts than one rank routes them to (each
rank routes its half of the sequence; the one-rank model routes it
whole), with the least gap between a token's k-th and (k+1)-th
probability among them; then the prefill logits' relative L2, and the
logits' relative L2 at each of ``--steps`` teacher-forced decode steps
(one query a row: the ranks run the replicated-token walk, each its
experts' rows, summed by an all_reduce).

Run from the repository root, on one card:  python3 tools/probe_ep_f32.py
(``--device cpu`` runs it at smoke size on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import generator_for  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.dep import DepGroups  # noqa: E402
from repro_torch.models import ExecutionContext, build_model  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


def config(args):
    cfg = (get_config if args.device == "cuda" else get_smoke_config)(
        "qwen2-moe-a2.7b")
    m = cfg.moe
    return dataclasses.replace(
        cfg, num_layers=args.layers, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))


class Record:
    """While entered, keeps each MoE layer's input and each routing's
    probabilities and expert ids (on the CPU)."""

    def __enter__(self):
        self.inputs, self.probs, self.experts = [], [], []
        self._apply, self._route = transformer._apply_moe, moe_lib.route_topk

        def apply(p, cfg, h, *a, **kw):
            self.inputs.append(h.detach().float().cpu())
            return self._apply(p, cfg, h, *a, **kw)

        def route(*a, **kw):
            r = self._route(*a, **kw)
            self.probs.append(r.probs.detach().float().cpu())
            self.experts.append(r.experts.detach().cpu())
            return r
        transformer._apply_moe, moe_lib.route_topk = apply, route
        return self

    def __exit__(self, *exc):
        transformer._apply_moe, moe_lib.route_topk = self._apply, self._route


def tokens(cfg, args):
    return torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, size=(args.batch, args.seq)))


def decode(model, params, caches, args, device):
    """``args.steps`` decode steps fed seeded tokens; each step's logits
    (float32, on the CPU)."""
    rng = np.random.RandomState(args.seed + 1)
    out = []
    for _ in range(args.steps):
        tok = torch.from_numpy(rng.randint(0, model.cfg.vocab_size,
                                           size=(args.batch, 1)))
        logits, caches = model.decode_step(params, tok.to(device), caches)
        out.append(logits.float().cpu())
    return out


@torch.no_grad()
def rank(r: int, store: str, args) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    groups = DepGroups.from_file_store(os.path.join(store, "store"), r, 1, 2,
                                       "gloo")
    cfg = config(args)
    model = build_model(cfg, ctx=ExecutionContext(
        attn_impl="decode_kernel", moe_impl="dep", groups=groups),
        dtype=torch.float32, device=device)
    params = model.init(generator_for(device, 0), expert_shard=(r, 2))
    with Record() as rec:
        logits, caches = model.prefill(params, tokens(cfg, args).to(device),
                                       seq_budget=args.seq + args.steps)
    steps = decode(model, params, caches, args, device)
    torch.save({"probs": rec.probs, "experts": rec.experts,
                "inputs": rec.inputs, "logits": logits.float().cpu(),
                "steps": steps}, os.path.join(store, f"rank{r}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@torch.no_grad()
def one_rank(store: str, args) -> dict:
    device = torch.device(args.device)
    cfg = config(args)
    model = build_model(cfg, ctx=ExecutionContext(attn_impl="decode_kernel"),
                        dtype=torch.float32, device=device)
    params = model.init(generator_for(device, 0))
    with Record() as rec:
        logits, caches = model.prefill(params, tokens(cfg, args).to(device),
                                       seq_budget=args.seq + args.steps)
    steps = decode(model, params, caches, args, device)
    return {"probs": rec.probs, "experts": rec.experts,
            "inputs": rec.inputs, "logits": logits.float().cpu(),
            "steps": steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=304)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_ep_f32: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="probe-ep-f32-") as store:
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
    want = one_rank(store, args)
    B, S, k = args.batch, args.seq, config(args).moe.top_k
    half = S // 2
    flips_total = 0
    for i, x in enumerate(want["inputs"]):
        d = float((got[0]["inputs"][i] - x).abs().max() / x.abs().max())
        full_p = want["probs"][i].view(B, S, -1)
        full_e = want["experts"][i].view(B, S, k)
        worst_p, flips, gaps = 0.0, 0, []
        for r in range(2):
            mine = slice(r * half, (r + 1) * half)
            p = got[r]["probs"][i].view(B, half, -1)
            e = got[r]["experts"][i].view(B, half, k)
            worst_p = max(worst_p, float((p - full_p[:, mine]).abs().max()))
            same = (e.sort(-1).values == full_e[:, mine].sort(-1).values
                    ).all(-1)
            flips += int((~same).sum())
            top = full_p[:, mine].topk(k + 1, dim=-1).values
            gap = (top[..., k - 1] - top[..., k])[~same]
            gaps += gap.tolist()
        flips_total += flips
        print(f"[probe ep f32] MoE layer {i}: input max |d| / max |x| "
              f"{d:.3e}; router probs max |d| {worst_p:.3e}; {flips} of "
              f"{B * S} tokens routed to another expert set"
              + (f" (k-th to (k+1)-th gap {min(gaps):.3e})" if gaps
                 else ""))
    lw, lg = want["logits"], got[0]["logits"]
    rel = float((lg - lw).norm() / lw.norm())
    print(f"[probe ep f32] {args.layers} layers, {B} x {S} tokens: prefill "
          f"logits relative L2 {rel:.3e}; {flips_total} reroutings in all; "
          f"the ranks' logits equal: "
          f"{bool(torch.equal(got[0]['logits'], got[1]['logits']))}")
    per_step = [float((g - w).flatten(1).norm(dim=1).max()
                      / w.flatten(1).norm(dim=1).min())
                for g, w in zip(got[0]["steps"], want["steps"])]
    worst_row = [float(((g - w).flatten(1).norm(dim=1)
                        / w.flatten(1).norm(dim=1)).max())
                 for g, w in zip(got[0]["steps"], want["steps"])]
    print(f"[probe ep f32] {args.steps} teacher-forced decode steps: the "
          f"worst row's relative L2 per step "
          f"{[round(x, 8) for x in worst_row]}; bound over rows "
          f"{max(per_step):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
