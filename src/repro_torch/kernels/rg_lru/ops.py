"""Public wrapper of the RG-LRU recurrence: dispatch by the tensors'
device. A CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel or raises.

Under autograd (grad mode on, an operand requiring a gradient) the call
goes through ``RGLRUScanFunction``: the forward is the same dispatch, the
backward ``rg_lru_scan_backward``, the hand-written reverse scan on the
card (``csrc/rg_lru_bwd.cu``) and its plain version on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_cuda_operands, check_tma_operands,
                                 counted, is_meta)
from repro_torch.kernels.rg_lru import kernel
from repro_torch.kernels.rg_lru.ref import (rg_lru_scan_backward_ref,
                                            rg_lru_scan_ref, wide)


def rg_lru_scan_work(a, b, h0):
    """(FLOPs, bytes) of ``rg_lru_scan``: a and b once (in their dtype),
    h0, h and h_last once (f32); one multiply-add per element."""
    B, S, W = a.shape
    nbytes = 2 * B * S * W * a.element_size() + 4 * (B * S * W + 2 * B * W)
    return 2.0 * B * S * W, float(nbytes)


def rg_lru_scan_backward_work(a, h0, hs, dhs, dh_last):
    """(FLOPs, bytes) of ``rg_lru_scan_backward``: a, hs and dhs read once
    and da and db written once ([B,S,W] f32), h0, dh_last and dh0 once
    ([B,W] f32); an add and two multiplies per element."""
    B, S, W = a.shape
    return 3.0 * B * S * W, float(4 * (5 * B * S * W + 3 * B * W))


def _forward(a, b, h0):
    return counted("rg_lru_scan", rg_lru_scan_work, (a, b, h0),
                   lambda: _rg_lru_scan(a, b, h0), dtype=torch.float32)


class RGLRUScanFunction(torch.autograd.Function):
    """``rg_lru_scan`` with a gradient: the forward is the kernel on the
    card (its plain version on the CPU) and counts as any call does; the
    backward is ``rg_lru_scan_backward`` on the saved a, h0 and h. da and
    db come back in a's and b's dtype."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = _forward(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        ctx.b_dtype = b.dtype
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        a, h0, h = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else wide(dh).contiguous()
        dh_last = (torch.zeros_like(h[:, 0]) if dh_last is None
                   else wide(dh_last).contiguous())
        da, db, dh0 = rg_lru_scan_backward(wide(a).contiguous(), h0, h, dh,
                                           dh_last)
        return da.to(a.dtype), db.to(ctx.b_dtype), dh0.to(h0.dtype)


def rg_lru_scan(a, b, h0):
    """a, b: [B,S,W] in f32 or bf16 (read as f32); h0: [B,W] f32 ->
    (h [B,S,W] f32, h_last [B,W] f32).

    Any S >= 1 (S = 1 is a decode step) runs: the reference's op sends
    shapes that do not tile its blocks to the oracle, the kernel masks its
    last block of channels instead. On the card a and b are copied in
    16-byte pieces, so they must be 16-byte aligned with W a multiple of
    16 bytes of their type (4 f32 or 8 bf16 values). Differentiable:
    under grad mode an operand that requires a gradient takes
    ``RGLRUScanFunction``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (a, b, h0)):
        return RGLRUScanFunction.apply(a, b, h0)
    return _forward(a, b, h0)


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


def rg_lru_scan_backward(a, h0, hs, dhs, dh_last):
    """The gradient of ``rg_lru_scan`` (the recurrence run in reverse
    time, ``ref.rg_lru_scan_backward_ref``). a, hs, dhs: [B,S,W] f32;
    h0, dh_last: [B,W] f32 -> (da, db [B,S,W], dh0 [B,W]), f32. The
    plain version on CPU tensors, the hand-written kernel on CUDA
    tensors; no grad of its own."""
    args = (a, h0, hs, dhs, dh_last)
    return counted("rg_lru_scan_backward", rg_lru_scan_backward_work, args,
                   lambda: _backward(*args), dtype=torch.float32)


def _backward(a, h0, hs, dhs, dh_last):
    if a.device.type == "cpu":
        return rg_lru_scan_backward_ref(a, h0, hs, dhs, dh_last)
    if is_meta(a):
        return (torch.empty_like(a), torch.empty_like(a),
                torch.empty_like(h0))
    B, S, W = a.shape
    if hs.shape != a.shape or dhs.shape != a.shape:
        raise ValueError(f"hs {tuple(hs.shape)} and dhs "
                         f"{tuple(dhs.shape)} must be a's {tuple(a.shape)}")
    if h0.shape != (B, W) or dh_last.shape != (B, W):
        raise ValueError(f"h0 and dh_last must be [B,W] = {(B, W)}")
    for t in (a, hs, dhs, h0, dh_last):
        if t.dtype != torch.float32:
            raise TypeError("rg_lru_scan_backward runs in float32, got "
                            f"{t.dtype}")
    check_cuda_operands("rg_lru_scan_backward", a, hs, dhs, h0, dh_last)
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    kernel.rg_lru_scan_backward_cuda(a, hs, h0, dhs, dh_last, da, db, dh0)
    rg_lru_scan_backward.launches += 1
    return da, db, dh0


#: kernel launches (plain-version calls on CPU tensors do not count)
rg_lru_scan_backward.launches = 0
