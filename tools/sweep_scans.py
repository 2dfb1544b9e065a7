#!/usr/bin/env python3
"""Time variants of the RG-LRU scan kernel side by side on one card, its
short kernel against its tile kernel, and the mLSTM wrapper's crossover
between its two routes.

Variants are the CUDA source ``src/repro_torch/csrc/rg_lru.cu`` with its
steps per stage (``kSteps``) and ring depth (``kStages``) patched. (The
mLSTM scan's ring has no such freedom: it needs three [16 x D] stages
for its lookahead of two, and a fourth does not fit at D = 1024.) All are
built in parallel with nvcc, loaded with ctypes, checked to give the same
bits as the first variant (the sizes change no arithmetic), then timed
in interleaved rounds by torch.profiler's device time per call
(``chip_smoke.device_ms``):

  rg_lru    f32, B=1 W=4096 at S=3000 (the hybrid 3000-token prefill's
            shape) and S=600, each after a 64 MB write (cold L2, minus the
            write's own time);
  short     the source with its short kernel taken at every S, against
            the source with the tile kernel taken at every S
            (``kShortBelowS``), f32, W=4096, B=1 and B=8 (decode's 8
            slots), S in 1..383 (a decode step, short prompts, tiles of
            128 with fewer than kStages tiles), warm: sets kShortBelowS;
  crossover the repository's own build: the recurrent kernel against the
            chunkwise pair at B=1 and B=8, H=4, D=1024, S in 1..16, which
            sets CHUNKWISE_MIN_S in kernels/mlstm_scan/ops.py.

Run from the repository root on a machine with one card:
    python3 tools/sweep_scans.py
Prints ptxas's registers and spills of each variant, one line per variant
and shape with every round's time, and the medians as one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as mk  # noqa: E402

#: (source, {constant: value}) per variant; the first of each is the source
VARIANTS = [("rg_lru.cu", {"kSteps": 128, "kStages": 3}),
            ("rg_lru.cu", {"kSteps": 128, "kStages": 4}),
            ("rg_lru.cu", {"kSteps": 256, "kStages": 2}),
            ("rg_lru.cu", {"kSteps": 256, "kStages": 3}),
            ("rg_lru.cu", {"kSteps": 64, "kStages": 6}),
            ("rg_lru.cu", {"kSteps": 32, "kStages": 8})]
#: the short-kernel crossover: every S to the short kernel, or none
SHORT_VARIANTS = [("rg_lru.cu", {"kShortBelowS": 1 << 30}),
                  ("rg_lru.cu", {"kShortBelowS": 1})]
ROUNDS = 5
CROSSOVER_S = (1, 2, 3, 4, 6, 8, 16)
SHORT_S = (1, 16, 32, 48, 64, 127, 128, 256, 383)


def name_of(var) -> str:
    return ",".join(
        f"{k}={v}" for k, v in var[1].items())


def variant_source(var) -> str:
    src = (build.CSRC_DIR / var[0]).read_text()
    for const, value in var[1].items():
        src, n = re.subn(rf"constexpr int {const} = \d+;",
                         f"constexpr int {const} = {value};", src)
        if n != 1:
            raise SystemExit(f"{const} not found in {var[0]}")
    return src


def make(i, var, root: Path):
    d = root / f"v{i}"
    d.mkdir(parents=True, exist_ok=True)
    (d / var[0]).write_text(variant_source(var))
    for f in ("common.cu", "common.cuh"):
        (d / f).write_text((build.CSRC_DIR / f).read_text())
    so = d / "lib.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                          "-o", str(so), str(d / var[0]),
                          str(d / "common.cu")], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {name_of(var)}:\n{res.stderr}")
    return var, so, res.stdout + res.stderr


def call(fn, *args):
    status = fn(*args, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"launch failed: CUDA error {status}")


def rg_lru_runner(fn, a, b, h0):
    def run():
        h = torch.empty(a.shape, dtype=torch.float32, device="cuda")
        h_last = torch.empty_like(h0)
        B, S, W = a.shape
        call(fn, build.DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
             h0.data_ptr(), h.data_ptr(), h_last.data_ptr(), B, S, W)
        return h
    return run


def short_crossover(gen, short, tile) -> dict:
    """Device ms of the short and the tile kernel at short S, warm, in
    interleaved rounds; both must give the same bits."""
    runs = {}
    for B in (1, 8):
        for S in SHORT_S:
            a = 0.8 + 0.199 * torch.rand((B, S, 4096), generator=gen,
                                         device="cuda")
            b = cs.randn(gen, (B, S, 4096), torch.float32, 0.1)
            h0 = cs.randn(gen, (B, 4096), torch.float32)
            pair = (rg_lru_runner(short, a, b, h0),
                    rg_lru_runner(tile, a, b, h0))
            if not torch.equal(pair[0](), pair[1]()):
                raise SystemExit(f"B={B} S={S}: the two kernels differ")
            runs[f"B={B} S={S}"] = pair
    times = {(label, i): [] for label in runs for i in range(2)}
    for rnd in range(ROUNDS):
        order = (0, 1) if rnd % 2 == 0 else (1, 0)
        for label, pair in runs.items():
            for i in order:
                times[label, i].append(
                    round(cs.device_ms(pair[i], "rg_lru"), 5))
    out = {}
    for label in runs:
        short_ms, tile_ms = (float(np.median(times[label, i]))
                             for i in range(2))
        out[label] = {"short": short_ms, "tile": tile_ms}
        print(f"[short] {label} W=4096 f32: short kernel "
              f"{times[label, 0]}, tile kernel {times[label, 1]} ms device "
              "per call")
    return out


def crossover(gen) -> dict:
    """Device ms of each route of the repository's build at short S."""
    out = {}
    for B in (1, 8):
        for S in CROSSOVER_S:
            args = cs.mlstm_inputs(gen, B, 4, S, 1024)
            outs = [torch.empty_like(x) for x in (args[0], *args[5:])]
            rec = torch.empty(mk.record_numel(B * 4, S), device="cuda")
            rec_ms = cs.device_ms(lambda: mk.mlstm_scan_cuda(*args, *outs),
                                  "mlstm_")
            chunk_ms = cs.device_ms(lambda: mk.mlstm_scan_chunkwise_cuda(
                *args, rec, *outs), "mlstm_")
            out[f"B={B} S={S}"] = {"recurrent": round(rec_ms, 5),
                                   "chunkwise": round(chunk_ms, 5)}
            print(f"[crossover] B={B} H=4 S={S} D=1024: recurrent "
                  f"{rec_ms:.5f} ms, chunkwise {chunk_ms:.5f} ms device")
            del args, outs, rec
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_scans: no CUDA device", file=sys.stderr)
        return 1
    root = build.BUILD_DIR / "sweep-scans"
    every = VARIANTS + SHORT_VARIANTS
    with ThreadPoolExecutor(len(every)) as ex:
        built = list(ex.map(lambda iv: make(*iv, root), enumerate(every)))
    fns = {}
    for var, so, log in built:
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas {name_of(var)}] {line.strip()}")
        fn = ctypes.CDLL(str(so)).repro_rg_lru_scan
        fn.argtypes = build._SIGNATURES["repro_rg_lru_scan"]
        fn.restype = ctypes.c_int
        fns[name_of(var)] = fn
    short, tile = (fns.pop(name_of(var)) for var in SHORT_VARIANTS)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = {}
    for S in (3000, 600):
        a = 0.8 + 0.199 * torch.rand((1, S, 4096), generator=gen,
                                     device="cuda")
        b = cs.randn(gen, (1, S, 4096), torch.float32, 0.1)
        h0 = cs.randn(gen, (1, 4096), torch.float32)
        cases[f"S={S} cold"] = (a, b, h0)
    runners = {}
    for label, inputs in cases.items():
        outs = {}
        for name, fn in fns.items():
            run = rg_lru_runner(fn, *inputs)
            runners[name, label] = run
            outs[name] = run()
        first = next(iter(outs.values()))
        for name, out in outs.items():
            if not torch.equal(out, first):
                raise SystemExit(f"{label}: {name} differs from the source")
        print(f"  {label}: every variant gives the same bits")

    flush_ms = cs.device_ms(flush.zero_)
    times = {key: [] for key in runners}
    for rnd in range(ROUNDS):
        keys = list(runners) if rnd % 2 == 0 else list(runners)[::-1]
        for key in keys:
            run = runners[key]
            ms = cs.device_ms(lambda: (flush.zero_(), run())) - flush_ms
            times[key].append(round(ms, 5))
    medians = {}
    for (name, label), vals in times.items():
        print(f"[sweep] {name} {label}: {vals} ms device per call")
        medians[f"{name} {label}"] = float(np.median(vals))
    short_ms = short_crossover(gen, short, tile)
    cross = crossover(gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"medians_ms": medians, "short_ms": short_ms,
                      "crossover_ms": cross,
                      "rounds": ROUNDS,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
