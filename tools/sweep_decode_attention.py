#!/usr/bin/env python3
"""Time variants of the decode-attention kernels side by side on one card.

Each variant is the CUDA source ``src/repro_torch/csrc/decode_attention.cu``
with its ring depth (``kStages``) and grid order patched: the chunk-major
grid of the source, or row-major (a row's chunks next to each other). All
variants are built in parallel with nvcc, loaded with ctypes, checked
against the plain version (and against each other: the sizes change no
arithmetic, so every variant must give the same bits), then timed in
interleaved rounds by torch.profiler's device time (split and combine
kernels together, per call).

Shapes, all bf16, H = Kv = 16, D = 128, C = 1024 (qwen2-moe's heads):

  mixed   chip_smoke.py's timed shape, lengths [0, 1, 1024, 37, 500,
          1000, 33, 613], ten calls on one input (warm L2);
  8x300   the decode profile's: 8 rows of 290-310 positions, warm;
  1x1024  one row of 1024 positions, warm;
  step    8x300 as a decode step meets it: 24 layers' caches called in
          turn, so each call finds its K/V out of L2.

Run from the repository root on a machine with one card:
    python3 tools/sweep_decode_attention.py
Prints ptxas's registers and spills of each variant's kernels, the
checks, one line per variant and shape with every round's time, and the
medians as one JSON line.
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
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402

CHUNK_MAJOR = """  const int n_bk = gridDim.x / n_chunks;  // B * Kv
  const int j = blockIdx.x / n_bk;
  const int bk = blockIdx.x - j * n_bk;   // b * Kv + kv head
"""
ROW_MAJOR = """  const int j = blockIdx.x % n_chunks;
  const int bk = blockIdx.x / n_chunks;
"""
#: (ring depth, grid order)
VARIANTS = [(3, "chunk-major"), (2, "chunk-major"), (4, "chunk-major"),
            (3, "row-major"), (4, "row-major")]
ROUNDS = 5
LAYERS = 24


def variant_source(stages: int, order: str) -> str:
    src = (build.CSRC_DIR / "decode_attention.cu").read_text()
    if CHUNK_MAJOR not in src:
        raise SystemExit("the source's grid decomposition changed: update "
                         "CHUNK_MAJOR")
    src, n = re.subn(r"constexpr int kStages = \d+;",
                     f"constexpr int kStages = {stages};", src)
    if n != 1:
        raise SystemExit("kStages not found in the source")
    return src.replace(CHUNK_MAJOR, ROW_MAJOR) if order == "row-major" \
        else src


def name_of(var) -> str:
    return f"{var[0]} stages, {var[1]}"


def make(var, root: Path):
    d = root / f"s{var[0]}-{var[1]}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "decode_attention.cu").write_text(variant_source(*var))
    for f in ("common.cu", "common.cuh"):
        (d / f).write_text((build.CSRC_DIR / f).read_text())
    so = d / "lib.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                          "-o", str(so), str(d / "decode_attention.cu"),
                          str(d / "common.cu")], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {name_of(var)}:\n{res.stderr}")
    return var, so, res.stdout + res.stderr


def runner(fn, q, k, v, lengths):
    B, H, D = q.shape
    C, Kv = k.shape[1], k.shape[2]

    def run():
        out = torch.empty_like(q)
        scratch = torch.empty(dec_kernel.scratch_numel(B, H, Kv, C, D),
                              dtype=torch.float32, device="cuda")
        status = fn(build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), lengths.data_ptr(), scratch.data_ptr(),
                    out.data_ptr(), B, H, Kv, C, D,
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"launch failed: CUDA error {status}")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_decode_attention: no CUDA device", file=sys.stderr)
        return 1
    root = build.BUILD_DIR / "sweep-decode-attention"
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda var: make(var, root), VARIANTS))
    fns = {}
    for var, so, log in built:
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas {name_of(var)}] {line.strip()}")
        fn = ctypes.CDLL(str(so)).repro_decode_attention
        fn.argtypes = build._SIGNATURES["repro_decode_attention"]
        fn.restype = ctypes.c_int
        fns[var] = fn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, H, Kv, D, C, dtype = 8, 16, 16, 128, 1024, torch.bfloat16
    near_300 = np.random.RandomState(5).randint(290, 311, size=B).tolist()
    cases = {}
    for label, lens in (("mixed", [0, 1, C, 37, 500, 1000, 33, 613]),
                        ("8x300", near_300), ("1x1024", [C])):
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        cases[label] = [(*cs._decode_inputs(gen, len(lens), H, Kv, D, C,
                                            dtype), lt)]
    lt = torch.tensor(near_300, dtype=torch.int32, device="cuda")
    cases["step"] = [(*cs._decode_inputs(gen, B, H, Kv, D, C, dtype), lt)
                     for _ in range(LAYERS)]

    for label, inputs in cases.items():
        q, k, v, lt = inputs[0]
        outs = [runner(fns[var], q, k, v, lt)() for var in VARIANTS]
        cs.compare(f"{label} {name_of(VARIANTS[0])}", outs[0],
                   decode_attention_ref(q, k, v, lt), dtype,
                   cs.DECODE_TOL[dtype])
        for var, out in zip(VARIANTS[1:], outs[1:]):
            if not torch.equal(out, outs[0]):
                raise SystemExit(f"{label}: {name_of(var)} differs from "
                                 f"{name_of(VARIANTS[0])}")
        print(f"  {label}: every variant gives the same bits")

    times = {name_of(var): {label: [] for label in cases}
             for var in VARIANTS}
    for rnd in range(ROUNDS):
        order = VARIANTS if rnd % 2 == 0 else VARIANTS[::-1]
        for var in order:
            for label, inputs in cases.items():
                runs = [runner(fns[var], *x) for x in inputs]
                ms = cs.device_ms(lambda: [r() for r in runs],
                                  "decode_attention_") / len(runs)
                times[name_of(var)][label].append(round(ms, 5))
    medians = {}
    for name, per_shape in times.items():
        for label, vals in per_shape.items():
            print(f"[sweep] {name} {label}: {vals} ms device per call")
        medians[name] = {label: float(np.median(vals))
                         for label, vals in per_shape.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"medians_ms": medians, "rounds": ROUNDS,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
