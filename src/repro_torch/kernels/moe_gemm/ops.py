"""Public wrapper of the grouped expert FFN: dispatch by the tensors'
device. A CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel or raises.

Under autograd (grad mode on, an operand requiring a gradient) the call
goes through ``MoEGemmFunction``: the forward is the same dispatch, the
backward ``moe_gemm_backward`` on either device. The reference computes
this gradient as the transpose of its einsums, outside any Pallas
kernel, so the backward's products are library GEMMs (``torch.bmm``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_cuda_operands, check_tma_operands,
                                 counted, is_meta)
from repro_torch.kernels.moe_gemm import kernel
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref


def moe_gemm_work(x, w_gate, w_up, w_down):
    """(FLOPs, bytes) of ``moe_gemm``: x and the output once, the three
    weight stacks once; 6·E·C·M·H FLOPs (three products)."""
    E, C, M = x.shape
    H = w_gate.shape[-1]
    return 6.0 * E * C * M * H, float((2 * E * C * M + 3 * E * M * H)
                                      * x.element_size())


def _forward(x, w_gate, w_up, w_down):
    return counted("moe_gemm", moe_gemm_work, (x, w_gate, w_up, w_down),
                   lambda: _dispatch(x, w_gate, w_up, w_down))


def _dispatch(x, w_gate, w_up, w_down):
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w_gate, w_up, w_down)
    if is_meta(x):
        return torch.empty_like(x)
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


def moe_gemm_backward(x, w_gate, w_up, w_down, dy):
    """The gradients (dx, dW_gate, dW_up, dW_down) of ``moe_gemm`` at its
    operands for the output's gradient ``dy`` [E, C, M], one code for
    both devices. g = x Wg and u = x Wu are recomputed per expert; then
    dWd = (silu(g)·u)^T dy, dh = dy Wd^T, dg = dh·u·silu'(g), du =
    dh·silu(g), dWg = x^T dg, dWu = x^T du and dx = dg Wg^T + du Wu^T.
    Each product is a ``torch.bmm`` in the operands' dtype, which
    accumulates in float32; the elementwise terms are float32, rounded to
    the operands' dtype before the product that reads them, and dx's two
    products are summed in float32. The results are in the operands'
    dtype."""
    dt = x.dtype
    dy = dy.to(dt)
    xt = x.transpose(1, 2)
    g = torch.bmm(x, w_gate).float()
    u = torch.bmm(x, w_up).float()
    sig = torch.sigmoid(g)
    silu = g * sig
    dw_down = torch.bmm((silu * u).to(dt).transpose(1, 2), dy)
    dh = torch.bmm(dy, w_down.transpose(1, 2)).float()
    dg = (dh * u * sig * (1 + g * (1 - sig))).to(dt)
    du = (dh * silu).to(dt)
    del g, u, sig, silu, dh
    dw_gate = torch.bmm(xt, dg)
    dw_up = torch.bmm(xt, du)
    dx = (torch.bmm(dg, w_gate.transpose(1, 2)).float()
          + torch.bmm(du, w_up.transpose(1, 2)).float()).to(dt)
    return dx, dw_gate, dw_up, dw_down


class MoEGemmFunction(torch.autograd.Function):
    """``moe_gemm`` with a gradient: the forward launches the kernel on
    the card (its plain version on the CPU) and counts as any call does;
    the backward is ``moe_gemm_backward`` (no kernel launch)."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        return _forward(x, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dy):
        x, w_gate, w_up, w_down = ctx.saved_tensors
        return moe_gemm_backward(x, w_gate, w_up, w_down, dy.contiguous())


def moe_gemm(x, w_gate, w_up, w_down):
    """Grouped expert SwiGLU FFN. x: [E, C, M]; w_gate/w_up: [E, M, H];
    w_down: [E, H, M] -> [E, C, M] in x's dtype. Any C runs: the kernels
    mask the ragged tiles (C=683 is what 8192 tokens give). bf16 runs the
    tensor-core kernel at every C (M and H multiples of 8, the operands
    16-byte aligned: TMA), f32 the SIMT kernel. Differentiable: under
    grad mode an operand that requires a gradient takes
    ``MoEGemmFunction``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_gate, w_up, w_down)):
        return MoEGemmFunction.apply(x, w_gate, w_up, w_down)
    return _forward(x, w_gate, w_up, w_down)


#: kernel launches (plain-version calls on CPU tensors do not count); under
#: remat a layer's forward runs twice per step and counts twice
moe_gemm.launches = 0
