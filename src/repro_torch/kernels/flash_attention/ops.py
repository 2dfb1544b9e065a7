"""Public wrapper of causal GQA flash attention: dispatch by the tensors'
device. A CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import check_cuda_operands
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, causal: bool = True, window=None):
    """q: [B,S,H,D]; k/v: [B,S,Kv,D] -> [B,S,H,D]. Any S runs: the
    kernel masks the ragged last tiles."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    B, S, H, D = q.shape
    if k.dim() != 4 or k.shape[:2] != (B, S) or k.shape[3] != D \
            or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of Kv={k.shape[2]}")
    if D not in kernel.HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {kernel.HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    check_cuda_operands("flash_attention", q, k, v)
    out = torch.empty_like(q)
    kernel.flash_attention_cuda(q, k, v, out, causal, window)
    flash_attention.launches += 1
    return out


#: kernel launches (plain-version calls on CPU tensors do not count)
flash_attention.launches = 0
