#!/usr/bin/env python3
"""Where the chunkwise mLSTM scan kernel's time goes, by ablation on one
card.

Each variant is ``src/repro_torch/csrc/mlstm_scan.cu`` with one part of
``mlstm_chunk_scan_kernel`` cut (its output is then wrong; only its time
is read):

  source     the kernel as it is;
  a/4        the Q C^T product with a quarter of its FFMA (the x
             components only), loads and reductions kept;
  no b       the C and n update on the K tile left out;
  no tiles   the Q and K tiles never copied (the stage barriers still
             complete), so the kernel runs on whatever the ring holds;
  no h       h never written (its sums still formed);
  no side    the chunk's record and v rows never copied and w.v never
             formed (work done once per chunk);
  one sync   the block barrier that ends each ring item left out (two of
             the four barriers of a chunk).

A longer chunk would divide what "no side" and "one sync" save by its
length over kChunk (the other parts are per step).

All are built in parallel with nvcc, loaded with ctypes and timed in
interleaved rounds at B=1, H=4, S=600, D=1024 (xlstm-1.3b's 600-token
prefill) by torch.profiler's device time of the scan kernel per call.
The difference to the source is what the part costs, as far as the parts
do not overlap.

Run from the repository root on a machine with one card:
    python3 tools/ablate_mlstm_scan.py
"""
from __future__ import annotations

import ctypes
import json
import os
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

VARIANTS = {
    "source": [],
    "a/4": [(f"acc[r] = fmaf(c[r][j].{x}, q4.{x}, acc[r]);", "{}")
            for x in "yzw"],
    "no b": [("      nv = scale4(ge, nv);\n",
              "      nv = scale4(ge, nv);\n      if (S < 0)\n")],
    "no tiles": [("sm90::mbar_arrive_expect_tx(bar, rows * D * 4);",
                  "sm90::mbar_arrive(bar);"),
                 ("      if (lane < rows)\n        sm90::bulk_load(",
                  "      if (S < 0)\n        sm90::bulk_load(")],
    "no h": [("      if (t0 + t < S && row0 + r < D)\n"
              "        *reinterpret_cast<float2*>",
              "      if (S < 0)\n        *reinterpret_cast<float2*>")],
    "no side": [("    if ((i & 1) == 0) {\n      float* sd = side",
                 "    if ((i & 1) == 0 && S < 0) {\n      float* sd = side"),
                ("      for (int x = tid; x < kChunk * kRows; "
                 "x += kScanThreads)\n        wvs[x] =",
                 "      for (int x = tid; S < 0 && x < kChunk * kRows; "
                 "x += kScanThreads)\n        wvs[x] =")],
    "one sync": [("    __syncthreads();   // the slot and side buffer may be "
                  "refilled next\n", "")],
}
ROUNDS = 5


def make(i, name, root: Path):
    src = (build.CSRC_DIR / "mlstm_scan.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"{name}: the source changed; update the patch")
        src = src.replace(old, new)
    d = root / f"v{i}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "mlstm_scan.cu").write_text(src)
    for f in ("common.cu", "common.cuh", "hopper.cuh"):
        (d / f).write_text((build.CSRC_DIR / f).read_text())
    so = d / "lib.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                          "-o", str(so), str(d / "mlstm_scan.cu"),
                          str(d / "common.cu")], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{res.stderr}")
    return name, so


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_mlstm_scan: no CUDA device", file=sys.stderr)
        return 1
    root = build.BUILD_DIR / "ablate-mlstm"
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda iv: make(iv[0], iv[1], root),
                            enumerate(VARIANTS)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, H, S, D = 1, 4, 600, 1024
    args = cs.mlstm_inputs(gen, B, H, S, D)
    h = torch.empty_like(args[0])
    C, n, m = (torch.empty_like(x) for x in args[5:])
    rec = torch.empty(mk.record_numel(B * H, S), device="cuda")
    runs = {}
    for name, so in built:
        fn = ctypes.CDLL(str(so)).repro_mlstm_scan_chunkwise
        fn.argtypes = build._SIGNATURES["repro_mlstm_scan_chunkwise"]
        fn.restype = ctypes.c_int

        def run(fn=fn):
            status = fn(*(x.data_ptr() for x in args), rec.data_ptr(),
                        h.data_ptr(), C.data_ptr(), n.data_ptr(),
                        m.data_ptr(), B * H, S, D,
                        torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"launch failed: CUDA error {status}")
        runs[name] = run
    times = {name: [] for name in runs}
    for rnd in range(ROUNDS):
        names = list(runs) if rnd % 2 == 0 else list(runs)[::-1]
        for name in names:
            times[name].append(round(cs.device_ms(runs[name],
                                                  "mlstm_chunk_scan"), 5))
    medians = {name: float(np.median(v)) for name, v in times.items()}
    for name, vals in times.items():
        print(f"[ablate] {name}: {vals} ms device per call; "
              f"{medians['source'] - medians[name]:+.4f} ms against the "
              "source")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"medians_ms": medians, "rounds": ROUNDS,
                      "shape": f"B={B} H={H} S={S} D={D}",
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
