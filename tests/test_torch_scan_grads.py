"""The scans' backwards on the CPU. ``rg_lru_scan_backward_ref`` and
``mlstm_scan_backward_ref`` are the plain versions the wrappers take on
CPU tensors and the functions the kernels of ``csrc/rg_lru_bwd.cu`` and
``csrc/mlstm_scan_bwd.cu`` compute; each is held against autograd of its
plain forward: f64 ``gradcheck`` through the wrappers' autograd
Functions at tiny shapes, and f32 at 1e-5 relative L2, at S = 1, at an S
that the kernels' chunk does not divide, and with the mLSTM's clamp on
and off. A backward that holds the stabiliser m constant fails where the
clamp is on. The Functions count their work under a ``StepCounter`` on
``meta`` (the dry run) and launch nothing on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.autograd import gradcheck  # noqa: E402

from repro_torch import kernels as kernel_lib  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as mlstm_kernel  # noqa: E402
from repro_torch.kernels.mlstm_scan.ops import (  # noqa: E402
    mlstm_scan, mlstm_scan_backward, mlstm_scan_backward_work)
from repro_torch.kernels.mlstm_scan.ref import (  # noqa: E402
    mlstm_scan_backward_ref, mlstm_scan_ref)
from repro_torch.kernels.rg_lru.ops import (  # noqa: E402
    rg_lru_scan, rg_lru_scan_backward, rg_lru_scan_backward_work)
from repro_torch.kernels.rg_lru.ref import (  # noqa: E402
    rg_lru_scan_backward_ref, rg_lru_scan_ref)
from repro_torch.roofline import StepCounter  # noqa: E402

#: relative L2 of a plain backward's gradient against autograd of the
#: plain forward, f32: the same operations in another order (read: at most
#: a few 1e-7)
REL_L2 = 1e-5
#: an S the backward's checkpoint chunk does not divide
RAGGED_S = mlstm_kernel.BACKWARD_CHUNK + 1


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _rng(seed):
    return np.random.RandomState(seed)


def rg_inputs(B, S, W, seed=0, dtype=torch.float32):
    rng = _rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (B, S, W))).to(dtype)
    b = torch.from_numpy(rng.randn(B, S, W) * 0.5).to(dtype)
    h0 = torch.from_numpy(rng.randn(B, W)).to(dtype)
    dhs = torch.from_numpy(rng.randn(B, S, W)).to(dtype)
    dl = torch.from_numpy(rng.randn(B, W)).to(dtype)
    return a, b, h0, dhs, dl


def mlstm_inputs(B, H, S, D, q_scale, seed=0, dtype=torch.float32,
                 n_scale=0.1):
    """Random operands and output gradients. A small ``q_scale`` keeps
    |n_t . q_t| under 1 (the clamp holds the denominator at 1); a large
    one with a large ``n_scale`` keeps it over 1 at every step."""
    rng = _rng(seed)

    def r(*shape, s=1.0):
        return torch.from_numpy(rng.randn(*shape) * s).to(dtype)

    q, k, v = r(B, H, S, D, s=q_scale), r(B, H, S, D, s=D ** -0.5), \
        r(B, H, S, D)
    ig, lf = r(B, H, S), F.logsigmoid(r(B, H, S) + 2.0)
    C0, n0, m0 = r(B, H, D, D, s=0.1), r(B, H, D, s=n_scale), r(B, H)
    grads = (r(B, H, S, D), r(B, H, D, D), r(B, H, D), r(B, H))
    return (q, k, v, ig, lf, C0, n0, m0), grads


def clamp_share(args) -> float:
    """The share of (b, h, t) whose denominator the clamp holds at 1."""
    q, k, v, ig, lf, C0, n0, m0 = args
    n, m, held = n0, m0, []
    for t in range(q.shape[2]):
        m_new = torch.maximum(lf[:, :, t] + m, ig[:, :, t])
        n = torch.exp(lf[:, :, t] + m - m_new)[..., None] * n \
            + torch.exp(ig[:, :, t] - m_new)[..., None] * k[:, :, t]
        held.append((n * q[:, :, t]).sum(-1).abs() < 1)
        m = m_new
    return float(torch.stack(held).float().mean())


def autograd_of_plain(fn, args, grads):
    ins = [x.detach().clone().requires_grad_() for x in args]
    outs = fn(*ins)
    return torch.autograd.grad(outs, ins, grads)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 7])
def test_rg_lru_gradcheck_f64(S):
    a, b, h0, _, _ = rg_inputs(2, S, 3, seed=S, dtype=torch.float64)
    ops = tuple(x.requires_grad_() for x in (a, b, h0))
    assert gradcheck(rg_lru_scan, ops)


@pytest.mark.parametrize("B,S,W", [(2, 1, 5), (3, RAGGED_S, 6),
                                   (1, 64, 8)])
def test_rg_lru_backward_matches_autograd_f32(B, S, W):
    """The plain backward against autograd of the plain forward, with a
    gradient on both outputs; the wrapper's Function gives the same. A
    backward whose dh is shifted by one step fails the limit."""
    a, b, h0, dhs, dl = rg_inputs(B, S, W, seed=B * S)
    want = autograd_of_plain(rg_lru_scan_ref, (a, b, h0), (dhs, dl))
    hs, _ = rg_lru_scan_ref(a, b, h0)
    got = rg_lru_scan_backward_ref(a, h0, hs, dhs, dl)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert rel_l2(g, w) <= REL_L2, rel_l2(g, w)
    ops = [x.clone().requires_grad_() for x in (a, b, h0)]
    outs = rg_lru_scan(*ops)
    assert "RGLRUScanFunction" in type(outs[0].grad_fn).__name__
    for g, w in zip(torch.autograd.grad(outs, ops, (dhs, dl)), want):
        assert rel_l2(g, w) <= REL_L2
    if S > 1:
        shifted = rg_lru_scan_backward_ref(a, h0, hs, dhs.roll(1, dims=1),
                                           dl)
        assert max(rel_l2(g, w) for g, w in zip(shifted, want)) > 100 * REL_L2


def test_rg_lru_bf16_gates_get_bf16_gradients():
    """The model's gates are f32, but the forward reads bf16 too: the
    Function returns each gradient in its operand's dtype, computed in
    f32 (the plain backward on the bf16 values read as f32)."""
    a, b, h0, dhs, dl = rg_inputs(2, 5, 4, seed=3)
    a16, b16 = a.bfloat16(), b.bfloat16()
    ops = [a16.requires_grad_(), b16.requires_grad_(), h0.requires_grad_()]
    got = torch.autograd.grad(rg_lru_scan(*ops), ops, (dhs, dl))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    want = autograd_of_plain(rg_lru_scan_ref,
                             (a16.float(), b16.float(), h0), (dhs, dl))
    torch.testing.assert_close(got[0], want[0].bfloat16())
    torch.testing.assert_close(got[2], want[2])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

CLAMP = {"clamp on": dict(q_scale=0.05), "clamp off": dict(q_scale=1e3,
                                                          n_scale=3.0)}


@pytest.mark.parametrize("clamp", sorted(CLAMP))
@pytest.mark.parametrize("S", [1, 5])
def test_mlstm_gradcheck_f64(clamp, S):
    args, _ = mlstm_inputs(1, 2, S, 3, seed=S, dtype=torch.float64,
                           **CLAMP[clamp])
    ops = tuple(x.requires_grad_() for x in args)
    assert gradcheck(mlstm_scan, ops)


@pytest.mark.parametrize("clamp", sorted(CLAMP))
@pytest.mark.parametrize("S", [1, RAGGED_S, 33])
def test_mlstm_backward_matches_autograd_f32(clamp, S):
    """Every gradient of the plain backward against autograd of the plain
    forward, with gradients on h and on the final C, n and m; the
    wrapper's Function gives the same (its C, n, m gradients zero when
    autograd gives none)."""
    args, grads = mlstm_inputs(2, 2, S, 8, seed=S, **CLAMP[clamp])
    share = clamp_share(args)
    assert (share == 1.0) if clamp == "clamp on" else (share == 0.0)
    want = autograd_of_plain(mlstm_scan_ref, args, grads)
    got = mlstm_scan_backward_ref(*args, *grads)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert rel_l2(g, w) <= REL_L2, rel_l2(g, w)
    ops = [x.clone().requires_grad_() for x in args]
    h = mlstm_scan(*ops)[0]
    assert "MLSTMScanFunction" in type(h.grad_fn).__name__
    only_h = autograd_of_plain(lambda *x: mlstm_scan_ref(*x)[0], args,
                               grads[0])
    for g, w in zip(torch.autograd.grad(h, ops, grads[0]), only_h):
        assert rel_l2(g, w) <= REL_L2


def test_mlstm_stabiliser_gradient_is_not_zero():
    """The control: a backward that holds m constant (no dm flowing back
    through m_t = max(lf_t + m_{t-1}, i_t)) fails the limit on the gate
    gradients where the clamp holds the denominator at 1, and agrees
    where it never does (there h is free of the stabiliser's scale and
    the flow sums to zero), given a gradient on h alone (the final C and
    n are stabilised states: they scale with exp(-m) at any clamp)."""
    for clamp, fails in (("clamp on", True), ("clamp off", False)):
        args, (dh, _, _, _) = mlstm_inputs(2, 2, 33, 8, seed=4,
                                           **CLAMP[clamp])
        want = mlstm_scan_backward_ref(*args, dh)
        control = mlstm_scan_backward_ref(*args, dh, drop_dm=True)
        worst = max(rel_l2(control[i], want[i]) for i in (3, 4, 7))
        if fails:
            assert worst > 100 * REL_L2, worst
        else:
            assert worst <= REL_L2, worst
        # q, k, v, C0 and n0 do not see the stabiliser's flow
        for i in (0, 1, 2, 5, 6):
            torch.testing.assert_close(control[i], want[i], rtol=0, atol=0)


def test_mlstm_function_refusals_and_launches():
    """Under grad the decode step's in-place C is refused (it overwrites
    the C0 the backward reads); under no_grad the call builds no graph;
    CPU calls launch no kernel, forward or backward."""
    args, grads = mlstm_inputs(1, 2, 3, 4, q_scale=1.0)
    ops = [x.clone().requires_grad_() for x in args]
    with pytest.raises(RuntimeError, match="c_in_place overwrites C0"):
        mlstm_scan(*ops, c_in_place=True)
    with torch.no_grad():
        assert mlstm_scan(*ops)[0].grad_fn is None
    kernel_lib.reset_launch_counts()
    torch.autograd.grad(mlstm_scan(*ops)[0].sum(), ops)
    h, _ = rg_lru_scan(*[x.clone().requires_grad_()
                         for x in rg_inputs(1, 3, 4)[:3]])
    h.sum().backward()
    counts = kernel_lib.launch_counts()
    assert counts["mlstm_scan_backward"] == 0
    assert counts["rg_lru_scan_backward"] == 0
    assert sum(counts.values()) == 0


def test_backwards_counted_on_meta():
    """The dry run: both Functions on ``meta`` operands under a
    StepCounter count each forward and each backward once, with the work
    of their ``*_work`` formulas, and launch nothing."""
    args, grads = mlstm_inputs(2, 3, 5, 8, q_scale=1.0)
    ops = [torch.empty_like(x, device="meta").requires_grad_()
           for x in args]
    rg = [torch.empty_like(x, device="meta").requires_grad_()
          for x in rg_inputs(2, 5, 8)[:3]]
    kernel_lib.reset_launch_counts()
    with StepCounter() as c:
        h = mlstm_scan(*ops)[0]
        dq = torch.autograd.grad(h, ops, torch.empty_like(h))[0]
        hs = rg_lru_scan(*rg)[0]
        da = torch.autograd.grad(hs, rg, torch.empty_like(hs))[0]
    assert dq.device.type == "meta" and dq.shape == args[0].shape
    assert da.device.type == "meta" and da.shape == rg[0].shape
    k = c.counts.kernels
    for name in ("mlstm_scan", "mlstm_scan_backward", "rg_lru_scan",
                 "rg_lru_scan_backward"):
        assert k[name]["calls"] == 1, (name, k)
    want = mlstm_scan_backward_work(*args, args[0], *grads)
    assert (k["mlstm_scan_backward"]["flops"],
            k["mlstm_scan_backward"]["bytes"]) == want
    a, h0 = rg[0], rg[2]
    assert (k["rg_lru_scan_backward"]["flops"],
            k["rg_lru_scan_backward"]["bytes"]) == \
        rg_lru_scan_backward_work(a, h0, a, a, h0)
    assert sum(kernel_lib.launch_counts().values()) == 0


def test_backward_wrappers_on_the_cpu_are_the_plain_versions():
    """On CPU tensors the backward wrappers return the plain versions'
    values exactly."""
    args, grads = mlstm_inputs(1, 2, 4, 4, q_scale=1.0)
    h = mlstm_scan_ref(*args)[0]
    for g, w in zip(mlstm_scan_backward(*args, h, *grads),
                    mlstm_scan_backward_ref(*args, *grads)):
        assert torch.equal(g, w)
    a, b, h0, dhs, dl = rg_inputs(2, 3, 4)
    hs = rg_lru_scan_ref(a, b, h0)[0]
    for g, w in zip(rg_lru_scan_backward(a, h0, hs, dhs, dl),
                    rg_lru_scan_backward_ref(a, h0, hs, dhs, dl)):
        assert torch.equal(g, w)
