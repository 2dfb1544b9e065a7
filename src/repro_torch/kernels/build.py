"""Build and load the port's CUDA kernels.

Every ``repro_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together; the
tensor-core kernels use inline PTX from ``csrc/hopper.cuh``, no CUTLASS,
and find ``cuTensorMapEncodeTiled`` through the runtime, so nothing is
linked beyond the CUDA runtime) and linked
into one shared library with a plain C interface, which is loaded with
``ctypes``. The library lands in ``.kernel-build/`` at the repository root
(listed in ``.gitignore``), named by a digest of the sources and flags, so
a checkout builds once at first use and again only when a source changes.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".kernel-build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: dtype codes of the C entry points (csrc/common.cuh ``DType``)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int

#: argtypes of every exported entry point
_SIGNATURES = {
    # dtype, q, k, v, lengths, scratch, out, B, H, Kv, C, D, stream
    "repro_decode_attention": [_INT] + [_VOIDP] * 6 + [_INT] * 5 + [_VOIDP],
    # dtype, q, k, v, lengths, table, scratch, out, B, H, Kv, bs, n_blocks,
    # D, stream
    "repro_decode_attention_paged": ([_INT] + [_VOIDP] * 7 + [_INT] * 6
                                     + [_VOIDP]),
    # dtype, x, wg, wu, wd, act, y, E, C, M, H, stream
    "repro_moe_gemm": [_INT] + [_VOIDP] * 6 + [_INT] * 4 + [_VOIDP],
    # q, k, v, i, log_f, C0, n0, m0, h, C, n, m, BH, S, D, stream
    "repro_mlstm_scan": [_VOIDP] * 12 + [_INT] * 3 + [_VOIDP],
    # q, k, v, i, log_f, C0, n0, m0, rec, h, C, n, m, BH, S, D, stream
    "repro_mlstm_scan_chunkwise": [_VOIDP] * 13 + [_INT] * 3 + [_VOIDP],
    # dtype, q, k, v, out, B, S, H, Kv, D, causal, window, stream
    "repro_flash_attention": [_INT] + [_VOIDP] * 4 + [_INT] * 7 + [_VOIDP],
    # dtype, a, b, h0, h, h_last, B, S, W, stream
    "repro_rg_lru_scan": [_INT] + [_VOIDP] * 5 + [_INT] * 3 + [_VOIDP],
    # a, hs, h0, dhs, dh_last, da, db, dh0, B, S, W, stream
    "repro_rg_lru_scan_backward": [_VOIDP] * 8 + [_INT] * 3 + [_VOIDP],
    # q, k, v, i, log_f, C0, n0, m0, h, dh, dC, dn, dm, gates, stats, nbuf,
    # nvec, rec, cst, gst, parts, zpart, dq, dk, dv, di, dlf, dC0, dn0, dm0,
    # BH, S, D, stream
    "repro_mlstm_scan_backward": [_VOIDP] * 30 + [_INT] * 3 + [_VOIDP],
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
#: what the last build did (seconds, whether it compiled, ptxas report)
last_build: Dict[str, object] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"


def build() -> Path:
    """Compile the sources into the shared library (a no-op when the
    library for these sources exists). Returns its path."""
    lib = library_path()
    if lib.exists():
        last_build.update(seconds=0.0, compiled=False, report="")
        return lib
    nvcc = nvcc_path()
    obj_dir = BUILD_DIR / f"obj-{lib.stem}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()

    def compile_one(src: Path):
        obj = obj_dir / (src.stem + ".o")
        start = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                              str(obj)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        return src, obj, res, time.perf_counter() - start

    srcs = sources()
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        done = list(pool.map(compile_one, srcs))
    report = [f"== {src.name} ({secs:.1f} s)\n{res.stdout}"
              for src, _, res, secs in done]
    failed = [src.name for src, _, res, _ in done if res.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(report))
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp.so"
    link = [nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _, _ in done]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    text = "\n".join(report)
    (BUILD_DIR / f"{lib.stem}.log").write_text(text)
    last_build.update(seconds=time.perf_counter() - t0, compiled=True,
                      report=text,
                      per_source={src.name: secs for src, _, _, secs in done})
    return lib


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with every
    entry point's ``argtypes``/``restype`` declared."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def call(name: str, *args) -> None:
    """Launch entry point ``name`` on the current CUDA stream; raise if it
    reports a CUDA error (a refused launch never runs, and a later
    synchronise would not report it)."""
    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    status = getattr(lib, name)(*args, stream)
    if status != 0:
        msg = lib.repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{name} failed: CUDA error {status} ({msg})")
