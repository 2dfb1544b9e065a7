"""Hand-written Hopper kernels of the port, one package each:
``kernel.py`` launches the CUDA source in ``repro_torch/csrc``, ``ref.py``
is the plain PyTorch version of the same function, and ``ops.py`` is the
public wrapper that dispatches by the tensor's device and counts launches.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.build import DTYPE_CODES


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


def _ops():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gemm.ops import moe_gemm
    return {"decode_attention": decode_attention,
            "moe_gemm": moe_gemm,
            "flash_attention": flash_attention}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _ops().items()}


def reset_launch_counts() -> None:
    for fn in _ops().values():
        fn.launches = 0
