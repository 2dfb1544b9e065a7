#!/usr/bin/env python3
"""Two readings behind chip_smoke's multimodal checks, each in a fresh
process on one card.

  trace   internvl2-1b and seamless-m4t-large-v2 at full width (bf16,
          weights from seed 0, 8 rows, a 64-token prompt), one eager
          ``make_serve_step`` profiled 1, 2, 3, 3 and 4 times a trace:
          the device events a trace holds, the names whose count is not
          a multiple of the steps, and the first and last events.
  small   chip_smoke's ``small_multimodal`` (the smoke models on the card
          against the CPU at f32, limit 1e-4), with PyTorch's defaults
          printed and TF32 matmuls as PyTorch leaves them (``off``) or
          switched on (``on``); a failure is printed, not raised.

Run from the repository root on a machine with one card:
  python3 tools/probe_multimodal.py trace
  python3 tools/probe_multimodal.py small off
"""
from __future__ import annotations

import collections
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

STEPS = (1, 2, 3, 3, 4)


def trace(arch: str) -> None:
    cfg = cs.get_config(arch)
    model = cs.build_model(cfg, ctx=cs.ExecutionContext(
        attn_impl="decode_kernel"), dtype=torch.bfloat16, device="cuda")
    params = model.init(cs.generator_for(model.device, 0))
    extra = cs.frontend_inputs(cfg, cs.MM_BATCH, cs.MM_PROMPT,
                               cs.generator_for(model.device, 1),
                               device=model.device, dtype=torch.bfloat16)
    toks = torch.from_numpy(np.random.RandomState(11).randint(
        0, cfg.vocab_size, size=(cs.MM_BATCH, cs.MM_PROMPT))).cuda()
    serve = cs.make_serve_step(model)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        logits, caches = cs.make_prefill_step(model)(params, toks, extra)
        memory = (model.encode(params, extra) if cfg.is_encoder_decoder
                  else None)
        caches = cs.grow_caches(caches, cs.MM_STEPS)
        nxt = logits[:, -1].argmax(-1)[:, None]
        for _ in range(3):
            serve(params, nxt, caches, memory=memory)
        torch.cuda.synchronize()
        for steps in STEPS:
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(steps):
                    serve(params, nxt, caches, memory=memory)
                torch.cuda.synchronize()
            events = sorted(cs.device_events(prof),
                            key=lambda e: e.time_range.start)
            counts = collections.Counter(e.name for e in events)
            odd = {n[:100]: c for n, c in counts.items() if c % steps}
            print(f"{arch}, {steps} steps: {len(events)} device events; "
                  f"names not a multiple of the steps: {odd}")
            for where, part in (("first", events[:3]),
                                ("last", events[-3:])):
                print(f"  {where}: " + "; ".join(
                    f"{e.name[:60]} at {e.time_range.start:.0f} us"
                    for e in part))


def small(tf32: str) -> None:
    print(f"defaults: matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}")
    torch.backends.cuda.matmul.allow_tf32 = tf32 == "on"
    try:
        cs.small_multimodal()
    except RuntimeError as e:
        print(f"failed with TF32 {tf32}: {e}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_multimodal: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["trace"]:
        for arch in ("internvl2-1b", "seamless-m4t-large-v2"):
            trace(arch)
            torch.cuda.empty_cache()
    elif argv[:1] == ["small"] and argv[1:] in (["off"], ["on"]):
        small(argv[1])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
