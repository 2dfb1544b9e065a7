"""Public wrapper of GQA flash attention, causal (decoder prefill) or
bidirectional (an encoder): dispatch by the tensors' device. A CPU tensor
takes the plain version; a CUDA tensor launches the hand-written kernel
or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_cuda_operands, check_tma_operands,
                                 counted, is_meta, refuse_grad)
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def attended_pairs(S: int, causal: bool = True, window=None) -> int:
    """The (query, key) pairs of one head of one row that the mask keeps:
    key j for query i when j <= i (causal) and i - j < window."""
    w = S if window is None else min(window, S)
    if causal:
        return w * (w + 1) // 2 + (S - w) * w
    return S * S - (S - w) * (S - w + 1) // 2


def flash_attention_work(q, k, v, causal: bool = True, window=None):
    """(FLOPs, bytes) of ``flash_attention``: q, k, v and the output once;
    4·D FLOPs (QK and PV) for each attended (query, key) pair of each
    head."""
    B, S, H, D = q.shape
    Kv = k.shape[2]
    flops = 4.0 * B * H * D * attended_pairs(S, causal, window)
    return flops, float((2 * B * S * H * D + 2 * B * S * Kv * D)
                        * q.element_size())


def flash_attention(q, k, v, causal: bool = True, window=None):
    """q: [B,S,H,D]; k/v: [B,S,Kv,D] -> [B,S,H,D]; ``causal=False``
    attends every key. Any S runs: the kernel masks the ragged last
    tiles. bf16 runs the tensor-core kernel (operands 16-byte aligned),
    f32 the SIMT kernel."""
    refuse_grad("flash_attention", q, k, v)
    return counted("flash_attention", flash_attention_work,
                   (q, k, v, causal, window),
                   lambda: _flash_attention(q, k, v, causal, window))


def _flash_attention(q, k, v, causal, window):
    if q.device.type == "cpu":
        # contiguous, as the kernel's output is
        return flash_attention_ref(q, k, v, causal=causal,
                                   window=window).contiguous()
    if is_meta(q):
        return torch.empty_like(q)
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
    if q.dtype == torch.bfloat16:   # the TMA-fed tensor-core kernel
        check_tma_operands("flash_attention", q, k, v)
    out = torch.empty_like(q)
    kernel.flash_attention_cuda(q, k, v, out, causal, window)
    flash_attention.launches += 1
    return out


#: kernel launches (plain-version calls on CPU tensors do not count)
flash_attention.launches = 0
