"""Hand-written Hopper kernels of the port, one package each:
``kernel.py`` launches the CUDA source in ``repro_torch/csrc``, ``ref.py``
is the plain PyTorch version of the same function, and ``ops.py`` is the
public wrapper that dispatches by the tensor's device and counts launches
(a CUDA graph's replays are added by ``runtime/decode_graph.py``).

Each wrapper also has a ``*_work`` function: the (FLOPs, bytes) the
function needs on its operands (each input read once, each output
written once; attention counts only the (query, key) pairs it attends).
A wrapper reports that work to the active step counter
(``roofline.StepCounter``) through ``counted``, on every device, and the
counter does not see the ops that the plain version dispatches. An
operand on the ``meta`` device takes a branch that returns an empty
``meta`` output of the right shape: it launches nothing and counts no
launch (the dry run, ``launch.dryrun``).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from repro_torch.kernels.build import DTYPE_CODES


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need the backward of a kernel that has
    none (the attention kernels: the reference never differentiates them
    either, it trains with ``attn_impl='xla'``): grad mode is on and an
    operand requires a gradient. Called before the device dispatch, so
    the plain version on the CPU refuses what the kernel on the card
    would; serving never trips it (its parameters require no
    gradient)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: no backward: an operand requires a gradient; the "
            "reference trains with attn_impl='xla' (train with it), or "
            "run under torch.no_grad()")


#: the active step counters (``roofline.StepCounter``), innermost last
_COUNTERS: List = []


def active_counter():
    """The innermost active step counter, or None."""
    return _COUNTERS[-1] if _COUNTERS else None


def counted(name: str, work: Callable, operands: tuple, run: Callable,
            dtype=None):
    """``run()``, the body of wrapper ``name``, with its work reported:
    under an active counter ``work(*operands)`` -> (flops, bytes) is added
    to the counter's kernel totals (FLOPs in ``dtype``, by default the
    first operand's), the
    aten ops ``run`` dispatches are hidden from it (the plain version's
    loop is not the function's work) and the outputs are tracked as
    live. With no counter (a captured decode step among them) nothing is
    read on the host."""
    c = active_counter()
    if c is None:
        return run()
    with c.paused():
        flops, nbytes = work(*operands)
        out = run()
    c.add_kernel(name, flops, nbytes, dtype or operands[0].dtype)
    c.track(out)
    return out


def is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def check_cuda_operands(name: str, *tensors, index=()) -> None:
    """Raise unless every operand is a contiguous CUDA tensor on one
    device, the float operands share one supported dtype, and the
    ``index`` operands (int32 vectors) are contiguous on that device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    dtype = tensors[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} is not supported "
                        f"({tuple(DTYPE_CODES)})")
    for t in tensors + tuple(index):
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")


def check_tma_operands(name: str, *tensors) -> None:
    """Raise unless every operand can be read by TMA or 16-byte copies:
    its data pointer 16-byte aligned, and its inner dimension a multiple
    of 16 bytes (8 bf16 or 4 f32 values), so every row stride is too."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             f"starts at {t.data_ptr():#x}, not 16-byte "
                             "aligned")
        if t.shape[-1] * t.element_size() % 16:
            raise ValueError(f"{name}: inner dimension {t.shape[-1]} of "
                             f"{t.dtype} is not a multiple of 16 bytes")


def _ops():
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_paged)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mlstm_scan.ops import (mlstm_scan,
                                                    mlstm_scan_backward)
    from repro_torch.kernels.moe_gemm.ops import moe_gemm
    from repro_torch.kernels.rg_lru.ops import (rg_lru_scan,
                                                rg_lru_scan_backward)
    return {"decode_attention": decode_attention,
            "decode_attention_paged": decode_attention_paged,
            "moe_gemm": moe_gemm,
            "flash_attention": flash_attention,
            "mlstm_scan": mlstm_scan,
            "rg_lru_scan": rg_lru_scan,
            "mlstm_scan_backward": mlstm_scan_backward,
            "rg_lru_scan_backward": rg_lru_scan_backward}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _ops().items()}


def reset_launch_counts() -> None:
    for fn in _ops().values():
        fn.launches = 0


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` to the wrappers' launch counts: a CUDA graph's replay
    launches the kernels it captured without passing through them."""
    ops = _ops()
    for name, n in counts.items():
        ops[name].launches += n
