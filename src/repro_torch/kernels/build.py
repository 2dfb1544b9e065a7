"""Build and load the port's CUDA kernels.

Every ``repro_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and linked
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
    # dtype, q, k, v, lengths, out, B, H, Kv, C, D, stream
    "repro_decode_attention": [_INT] + [_VOIDP] * 5 + [_INT] * 5 + [_VOIDP],
    # dtype, x, wg, wu, wd, act, y, E, C, M, H, stream
    "repro_moe_gemm": [_INT] + [_VOIDP] * 6 + [_INT] * 4 + [_VOIDP],
    # dtype, q, k, v, out, B, S, H, Kv, D, causal, window, stream
    "repro_flash_attention": [_INT] + [_VOIDP] * 4 + [_INT] * 7 + [_VOIDP],
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
    procs = []
    for src in sources():
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        report.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(report))
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp.so"
    link = [nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    text = "\n".join(report)
    (BUILD_DIR / f"{lib.stem}.log").write_text(text)
    last_build.update(seconds=time.perf_counter() - t0, compiled=True,
                      report=text)
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
