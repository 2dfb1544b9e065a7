"""Public wrapper of the mLSTM recurrence: dispatch by the tensors'
device. A CPU tensor takes the plain version; a CUDA tensor launches one
of the two hand-written routes or raises.

Under autograd (grad mode on, an operand requiring a gradient) the call
goes through ``MLSTMScanFunction``: the forward is the same dispatch, the
backward ``mlstm_scan_backward``, the hand-written kernels of
``csrc/mlstm_scan_bwd.cu`` on the card and their plain version on the
CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_cuda_operands, check_tma_operands,
                                 counted, is_meta)
from repro_torch.kernels.mlstm_scan import kernel
from repro_torch.kernels.mlstm_scan.ref import (mlstm_scan_backward_ref,
                                                mlstm_scan_ref)

#: the least S that takes the chunkwise route; shorter calls (a decode step
#: is S = 1) take the recurrent kernel, which reads and writes the state
#: once and is bound by those bytes there. tools/sweep_scans.py times both
#: at H = 4, D = 1024 (NVIDIA H100 80GB HBM3, 700 W): at S = 8 they tie at
#: B = 1 (0.0238 / 0.0237 ms) and the chunkwise pair wins at B = 8 (0.217 /
#: 0.169 ms); at S = 6 the recurrent kernel wins at B = 1 (0.019 / 0.023)
CHUNKWISE_MIN_S = 8


def route(S: int) -> str:
    """The CUDA route for a call of ``S`` steps, by S alone (no host read
    of any tensor, so a captured decode step stays capturable)."""
    return "chunkwise" if S >= CHUNKWISE_MIN_S else "recurrent"


def mlstm_scan_work(q, k, v, i_gate, log_f, C0, n0, m0, c_in_place=False):
    """(FLOPs, bytes) of ``mlstm_scan``: q, k, v, h, the gates, C in and
    out, n in and out and m in and out once (f32); 4·D² FLOPs per step of
    each head (the C update and the readout)."""
    B, H, S, D = q.shape
    nbytes = 4 * (4 * B * H * S * D + 2 * B * H * S + 2 * B * H * D * D
                  + 2 * B * H * D + 2 * B * H)
    return 4.0 * D * D * S * H * B, float(nbytes)


def mlstm_scan(q, k, v, i_gate, log_f, C0, n0, m0, c_in_place=False):
    """q,k,v: [B,H,S,D] f32; i_gate/log_f: [B,H,S] f32; C0: [B,H,D,D];
    n0: [B,H,D]; m0: [B,H] (f32 state) -> (h [B,H,S,D], C, n, m).

    Any S >= 1 runs (S = 1 is a decode step), with no block-size
    condition: the reference's op sends S not divisible by its block to
    the oracle, the kernels mask instead. D is at most ``kernel.MAX_D``;
    the chunkwise route (S >= ``CHUNKWISE_MIN_S``) also needs 16-byte
    aligned operands and D % 4 == 0.

    ``c_in_place`` writes the final C over C0 and returns C0 itself (the
    decode step's state stays in its tensor, with no copy of C's D^2
    values per head). Only the recurrent route takes it: each of its
    threads reads its entries of C0 before it writes them.

    Differentiable: under grad mode an operand that requires a gradient
    takes ``MLSTMScanFunction`` (``c_in_place`` is refused there: it
    overwrites C0, which the backward reads).
    """
    ops = (q, k, v, i_gate, log_f, C0, n0, m0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        if c_in_place:
            raise RuntimeError(
                "mlstm_scan: c_in_place overwrites C0, which the backward "
                "reads; run it under torch.no_grad()")
        return MLSTMScanFunction.apply(*ops)
    return _forward(*ops, c_in_place)


def _forward(q, k, v, i_gate, log_f, C0, n0, m0, c_in_place=False):
    args = (q, k, v, i_gate, log_f, C0, n0, m0, c_in_place)
    return counted("mlstm_scan", mlstm_scan_work, args,
                   lambda: _mlstm_scan(*args))


class MLSTMScanFunction(torch.autograd.Function):
    """``mlstm_scan`` with a gradient: the forward is the kernel route on
    the card (its plain version on the CPU) and counts as any call does;
    the backward is ``mlstm_scan_backward`` on the saved operands and h.
    Gradients of the final C, n and m that autograd does not provide are
    zeros."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, log_f, C0, n0, m0):
        h, C, n, m = _forward(q, k, v, i_gate, log_f, C0, n0, m0)
        ctx.save_for_backward(q, k, v, i_gate, log_f, C0, n0, m0, h)
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        saved = ctx.saved_tensors
        h, C0, n0, m0 = saved[8], saved[5], saved[6], saved[7]
        grads = [torch.zeros_like(x) if g is None else g.contiguous()
                 for g, x in ((dh, h), (dC, C0), (dn, n0), (dm, m0))]
        return mlstm_scan_backward(*saved, *grads)


def _mlstm_scan(q, k, v, i_gate, log_f, C0, n0, m0, c_in_place):
    if is_meta(q):
        C = C0 if c_in_place else torch.empty_like(C0)
        return torch.empty_like(q), C, torch.empty_like(n0), \
            torch.empty_like(m0)
    if q.device.type == "cpu":
        h, C, n, m = mlstm_scan_ref(q, k, v, i_gate, log_f, C0, n0, m0)
        if c_in_place:
            C = C0.copy_(C)
        return h, C, n, m
    B, H, S, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v differ in shape")
    if i_gate.shape != (B, H, S) or log_f.shape != (B, H, S):
        raise ValueError(f"gates must be [B,H,S] = {(B, H, S)}")
    if C0.shape != (B, H, D, D) or n0.shape != (B, H, D) \
            or m0.shape != (B, H):
        raise ValueError("state shapes do not match q")
    if S < 1 or D > kernel.MAX_D:
        raise ValueError(f"unsupported S={S}, D={D} (D <= {kernel.MAX_D})")
    if q.dtype != torch.float32:
        raise TypeError(f"mlstm_scan runs in float32, got {q.dtype}")
    check_cuda_operands("mlstm_scan", q, k, v, i_gate, log_f, C0, n0, m0)
    if c_in_place and route(S) != "recurrent":
        raise ValueError(f"c_in_place needs the recurrent route (S < "
                         f"{CHUNKWISE_MIN_S}), got S={S}")
    h = torch.empty_like(q)
    C = C0 if c_in_place else torch.empty_like(C0)
    n, m = torch.empty_like(n0), torch.empty_like(m0)
    if route(S) == "chunkwise":
        rec = torch.empty(kernel.record_numel(B * H, S), dtype=torch.float32,
                          device=q.device)
        check_tma_operands("mlstm_scan", q, k, v, C0, n0, h, C, n, rec)
        kernel.mlstm_scan_chunkwise_cuda(q, k, v, i_gate, log_f, C0, n0, m0,
                                         rec, h, C, n, m)
    else:
        kernel.mlstm_scan_cuda(q, k, v, i_gate, log_f, C0, n0, m0, h, C, n,
                               m)
    mlstm_scan.launches += 1
    return h, C, n, m


#: calls that launched a kernel route (plain-version calls on CPU tensors do
#: not count)
mlstm_scan.launches = 0


def mlstm_scan_backward_work(q, k, v, i_gate, log_f, C0, n0, m0, h, dh, dC,
                             dn, dm):
    """(FLOPs, bytes) of ``mlstm_scan_backward``: q, k, v, h and dh read
    and dq, dk, dv written once ([B,H,S,D]), the gates read and their
    gradients written ([B,H,S]), C0 and dC read and dC0 written, the same
    for n and m (f32); 12·D² FLOPs per step of each head (C_t, dC~, and
    the contractions dq, dk, dv and df', a multiply-add per entry each)."""
    B, H, S, D = q.shape
    nbytes = 4 * (8 * B * H * S * D + 4 * B * H * S + 3 * B * H * D * D
                  + 3 * B * H * D + 3 * B * H)
    return 12.0 * D * D * S * H * B, float(nbytes)


def mlstm_scan_backward(q, k, v, i_gate, log_f, C0, n0, m0, h, dh, dC, dn,
                        dm):
    """The gradient of ``mlstm_scan`` with respect to q, k, v, i_gate,
    log_f, C0, n0 and m0 (``ref.mlstm_scan_backward_ref`` has the
    formulas), from the forward's operands, its output h, dh and the
    gradients of the final C, n and m; all f32 -> (dq, dk, dv, di, dlf,
    dC0, dn0, dm0). The plain version on CPU tensors; on CUDA tensors the
    hand-written chunkwise kernels (chunks of ``kernel.BACKWARD_CHUNK``
    steps, every chunk's gradients in parallel), which keep the state
    entering and the gradient leaving every chunk in scratch made in the
    call (``kernel.backward_scratch``, freed with it). D <=
    ``kernel.MAX_D``, D % 4 == 0."""
    args = (q, k, v, i_gate, log_f, C0, n0, m0, h, dh, dC, dn, dm)
    return counted("mlstm_scan_backward", mlstm_scan_backward_work, args,
                   lambda: _backward(*args))


def _backward(q, k, v, i_gate, log_f, C0, n0, m0, h, dh, dC, dn, dm):
    if q.device.type == "cpu":
        return mlstm_scan_backward_ref(q, k, v, i_gate, log_f, C0, n0, m0,
                                       dh, dC, dn, dm)
    outs = (q, k, v, i_gate, log_f, C0, n0, m0)
    if is_meta(q):
        return tuple(torch.empty_like(x) for x in outs)
    B, H, S, D = q.shape
    for name, x, want in (("k", k, q.shape), ("v", v, q.shape),
                          ("h", h, q.shape), ("dh", dh, q.shape),
                          ("i_gate", i_gate, (B, H, S)),
                          ("log_f", log_f, (B, H, S)),
                          ("C0", C0, (B, H, D, D)), ("dC", dC, (B, H, D, D)),
                          ("n0", n0, (B, H, D)), ("dn", dn, (B, H, D)),
                          ("m0", m0, (B, H)), ("dm", dm, (B, H))):
        if x.shape != want:
            raise ValueError(f"mlstm_scan_backward: {name} "
                             f"{tuple(x.shape)}, want {tuple(want)}")
    if D > kernel.MAX_D or D % 4:
        raise ValueError(f"mlstm_scan_backward: unsupported D={D} (D <= "
                         f"{kernel.MAX_D}, D % 4 == 0)")
    if q.dtype != torch.float32:
        raise TypeError(f"mlstm_scan_backward runs in float32, got "
                        f"{q.dtype}")
    check_cuda_operands("mlstm_scan_backward", q, k, v, i_gate, log_f, C0,
                        n0, m0, h, dh, dC, dn, dm)
    scratch = {name: torch.empty(shape, dtype=torch.float32,
                                 device=q.device)
               for name, shape in kernel.backward_scratch(B * H, S, D)
               .items()}
    grads = tuple(torch.empty_like(x) for x in outs)
    check_tma_operands("mlstm_scan_backward", q, k, v, h, dh, C0, dC,
                       *grads[:3], grads[5],
                       *(scratch[name] for name in ("rec", "cst", "gst")))
    kernel.mlstm_scan_backward_cuda(q, k, v, i_gate, log_f, C0, n0, m0, h,
                                    dh, dC, dn, dm, scratch, *grads)
    mlstm_scan_backward.launches += 1
    return grads


#: calls that launched the backward's kernels (plain-version calls on CPU
#: tensors do not count)
mlstm_scan_backward.launches = 0
