"""Public wrapper of the RG-LRU recurrence: dispatch by the tensors'
device. A CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_cuda_operands, check_tma_operands,
                                 counted, is_meta, refuse_grad)
from repro_torch.kernels.rg_lru import kernel
from repro_torch.kernels.rg_lru.ref import rg_lru_scan_ref


def rg_lru_scan_work(a, b, h0):
    """(FLOPs, bytes) of ``rg_lru_scan``: a and b once (in their dtype),
    h0, h and h_last once (f32); one multiply-add per element."""
    B, S, W = a.shape
    nbytes = 2 * B * S * W * a.element_size() + 4 * (B * S * W + 2 * B * W)
    return 2.0 * B * S * W, float(nbytes)


def rg_lru_scan(a, b, h0):
    """a, b: [B,S,W] in f32 or bf16 (read as f32); h0: [B,W] f32 ->
    (h [B,S,W] f32, h_last [B,W] f32).

    Any S >= 1 (S = 1 is a decode step) runs: the reference's op sends
    shapes that do not tile its blocks to the oracle, the kernel masks its
    last block of channels instead. On the card a and b are copied in
    16-byte pieces, so they must be 16-byte aligned with W a multiple of
    16 bytes of their type (4 f32 or 8 bf16 values)."""
    refuse_grad("rg_lru_scan", a, b, h0)
    return counted("rg_lru_scan", rg_lru_scan_work, (a, b, h0),
                   lambda: _rg_lru_scan(a, b, h0), dtype=torch.float32)


def _rg_lru_scan(a, b, h0):
    if a.device.type == "cpu":
        return rg_lru_scan_ref(a, b, h0)
    if is_meta(a):
        return (torch.empty(a.shape, dtype=torch.float32, device="meta"),
                torch.empty_like(h0))
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         "be one [B,S,W] shape")
    B, S, W = a.shape
    if h0.shape != (B, W):
        raise ValueError(f"h0 {tuple(h0.shape)} must be [B,W] = {(B, W)}")
    if S < 1 or W < 1:
        raise ValueError(f"unsupported S={S}, W={W}")
    if h0.dtype != torch.float32:
        raise TypeError(f"rg_lru_scan: h0 must be float32, got {h0.dtype}")
    check_cuda_operands("rg_lru_scan", a, b)
    check_tma_operands("rg_lru_scan", a, b)
    check_cuda_operands("rg_lru_scan", h0)
    if h0.device != a.device:
        raise ValueError(f"rg_lru_scan: operands on {h0.device} and "
                         f"{a.device}")
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    h_last = torch.empty_like(h0)
    kernel.rg_lru_scan_cuda(a, b, h0, h, h_last)
    rg_lru_scan.launches += 1
    return h, h_last


#: kernel launches (plain-version calls on CPU tensors do not count)
rg_lru_scan.launches = 0
