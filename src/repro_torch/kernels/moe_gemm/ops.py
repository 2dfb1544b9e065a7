"""Public wrapper of the grouped expert FFN: dispatch by the tensors'
device. A CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import check_cuda_operands, check_tma_operands
from repro_torch.kernels.moe_gemm import kernel
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref


def moe_gemm(x, w_gate, w_up, w_down):
    """Grouped expert SwiGLU FFN. x: [E, C, M]; w_gate/w_up: [E, M, H];
    w_down: [E, H, M] -> [E, C, M] in x's dtype. Any C runs: the kernels
    mask the ragged tiles (C=683 is what 8192 tokens give). bf16 runs the
    tensor-core kernel at every C (M and H multiples of 8, the operands
    16-byte aligned: TMA), f32 the SIMT kernel."""
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w_gate, w_up, w_down)
    E, C, M = x.shape
    H = w_gate.shape[-1]
    if (w_gate.shape != (E, M, H) or w_up.shape != (E, M, H)
            or w_down.shape != (E, H, M)):
        raise ValueError(
            f"expert weights {tuple(w_gate.shape)}/{tuple(w_up.shape)}/"
            f"{tuple(w_down.shape)} do not match x {tuple(x.shape)}")
    check_cuda_operands("moe_gemm", x, w_gate, w_up, w_down)
    if x.dtype == torch.bfloat16:   # the TMA-fed tensor-core kernel
        check_tma_operands("moe_gemm", x, w_gate, w_up, w_down)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    act = torch.empty((E, C, H), dtype=x.dtype, device=x.device)
    kernel.moe_gemm_cuda(x, w_gate, w_up, w_down, act, out)
    moe_gemm.launches += 1
    return out


#: kernel launches (plain-version calls on CPU tensors do not count)
moe_gemm.launches = 0
