"""The chunkwise algebra of the mLSTM backward's kernels
(``csrc/mlstm_scan_bwd.cu``) on the CPU. ``mlstm_scan_backward_chunkwise_ref``
states it in plain PyTorch; here it is held against the step-by-step
plain backward (``mlstm_scan_backward_ref``, the wrapper's CPU version) at
1e-5 relative L2 in f32 over the cases where a chunked form slips: S of
one step, either side of a chunk and past two chunks; the clamp on and
off; a fresh state (m0 = -1e30, C0 = n0 = 0, as the reference's
``mlstm_state`` makes it) and a random one; the final state's gradients
zero and not. One case also holds it against ``jax.grad`` of a
``lax.scan`` over the reference's ``_mlstm_cell``. A control that forms
the gate terms without dC (``drop_seed``) fails dlf wherever dC reaches
it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as mlstm_kernel  # noqa: E402
from repro_torch.kernels.mlstm_scan.ref import (  # noqa: E402
    mlstm_scan_backward_chunkwise_ref, mlstm_scan_backward_ref,
    mlstm_scan_ref)

#: relative L2 of each gradient against the step-by-step plain backward,
#: f32: the same function summed in another order (read: at most a few
#: 1e-7 at these sizes)
REL_L2 = 1e-5
L = mlstm_kernel.BACKWARD_CHUNK
NAMES = ("dq", "dk", "dv", "di", "dlf", "dC0", "dn0", "dm0")
#: q's scale: "on" keeps |n_t . q_t| under 1 at every step (the clamp
#: holds d_t at 1), "off" keeps it over 1 at most steps (the n path
#: live). A far larger q makes h all but independent of q's size (it is
#: homogeneous of degree 0 in q where the clamp is off), and dq then
#: cancels to a few digits in either form: that tests f32, not the
#: algebra
CLAMP = {"on": 0.02, "off": 3.0}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def inputs(S, D, clamp, state, final, seed=0, B=1, H=2):
    """Operands from numpy's generator (raw forget-gate pre-activations in
    ``f``) and the output gradients, those of the final state zero or
    not."""
    rng = np.random.RandomState(seed)

    def r(*shape, s=1.0):
        return torch.from_numpy(rng.randn(*shape) * s).float()

    q, k, v = r(B, H, S, D, s=CLAMP[clamp]), r(B, H, S, D, s=D ** -0.5), \
        r(B, H, S, D)
    ig, f = r(B, H, S), r(B, H, S) + 2.0
    C0, n0, m0 = r(B, H, D, D, s=0.1), r(B, H, D, s=0.5), r(B, H)
    if state == "fresh":
        C0, n0, m0 = C0.zero_(), n0.zero_(), m0.fill_(-1e30)
    grads = [r(B, H, S, D), r(B, H, D, D), r(B, H, D), r(B, H)]
    if final == "zero":
        grads[1:] = [torch.zeros_like(x) for x in grads[1:]]
    return (q, k, v, ig, F.logsigmoid(f), C0, n0, m0), f, grads


def clamp_share(args) -> float:
    h_den = []
    q, k, v, ig, lf, C0, n0, m0 = args
    n, m = n0, m0
    for t in range(q.shape[2]):
        m_new = torch.maximum(lf[:, :, t] + m, ig[:, :, t])
        n = torch.exp(lf[:, :, t] + m - m_new)[..., None] * n \
            + torch.exp(ig[:, :, t] - m_new)[..., None] * k[:, :, t]
        h_den.append((n * q[:, :, t]).sum(-1).abs() < 1)
        m = m_new
    return float(torch.stack(h_den).float().mean())


@pytest.mark.parametrize("final", ["zero", "nonzero"])
@pytest.mark.parametrize("state", ["fresh", "random"])
@pytest.mark.parametrize("D", [8, 12])
@pytest.mark.parametrize("clamp", sorted(CLAMP))
@pytest.mark.parametrize("S", [1, L - 1, L, L + 1, 2 * L + 3])
def test_chunkwise_matches_stepwise(S, clamp, D, state, final):
    """Every gradient of the chunkwise mirror within REL_L2 of the
    step-by-step plain backward, and, with dC not zero, the control
    without dC misses it in dlf wherever dC reaches dlf (not at S = 1 from
    a fresh state: C_{-1} = 0 and f'_0 = 0 there)."""
    args, _, grads = inputs(S, D, clamp, state, final, seed=S + D)
    share = clamp_share(args)
    assert share == 1.0 if clamp == "on" else share <= 0.5, share
    want = mlstm_scan_backward_ref(*args, *grads)
    got = mlstm_scan_backward_chunkwise_ref(*args, *grads, chunk=L)
    for n, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, n
        assert torch.isfinite(g).all(), n
        assert rel_l2(g, w) <= REL_L2, (n, rel_l2(g, w))
    if final == "nonzero" and (state == "random" or S > 1):
        control = mlstm_scan_backward_chunkwise_ref(
            *args, *grads, chunk=L, drop_seed=True)
        assert rel_l2(control[4], want[4]) > 100 * REL_L2
        # the control changes only the gate terms
        for i in (0, 1, 2, 5, 6):
            torch.testing.assert_close(control[i], got[i], rtol=0, atol=0)


def _jax_grads(args, f, grads):
    """``jax.grad`` of sum(h dh) + <C, dC> + n . dn + m . dm through a
    lax.scan of the reference's ``_mlstm_cell`` (raw forget gate f), in
    the port's [B, H, S, D] layout."""
    q, k, v, ig, _, C0, n0, m0 = (jnp.asarray(x.numpy()) for x in args)
    dh, dC, dn, dm = (jnp.asarray(x.numpy()) for x in grads)
    fr = jnp.asarray(f.numpy())

    def loss(q, k, v, ig, fr, C0, n0, m0):
        state = {"C": C0, "n": n0, "m": m0,
                 "conv": jnp.zeros((q.shape[0], 3, 1), jnp.float32)}
        xs = tuple(jnp.moveaxis(x, 2, 0) for x in (q, k, v, ig, fr))
        final, hs = jax.lax.scan(jax_ssm._mlstm_cell, state, xs)
        h = jnp.moveaxis(hs, 0, 2)
        return (jnp.sum(h * dh) + jnp.sum(final["C"] * dC)
                + jnp.sum(final["n"] * dn) + jnp.sum(final["m"] * dm))

    out = jax.grad(loss, argnums=tuple(range(8)))(q, k, v, ig, fr, C0, n0,
                                                  m0)
    return [torch.from_numpy(np.array(x)) for x in out]


def test_chunkwise_matches_jax_grad_of_the_cell():
    """The mirror against jax.grad of the reference's cell at two chunks
    and one step, every gradient of the final state non-zero: dlf through
    log-sigmoid's derivative (d lf / d f = sigmoid(-f)) is the raw forget
    gate's gradient."""
    S, D = L + 1, 8
    args, f, grads = inputs(S, D, "off", "random", "nonzero", seed=7)
    want = _jax_grads(args, f, grads)
    got = list(mlstm_scan_backward_chunkwise_ref(*args, *grads, chunk=L))
    got[4] = got[4] * torch.sigmoid(-f)
    for n, g, w in zip(NAMES, got, want):
        assert rel_l2(g, w) <= REL_L2, (n, rel_l2(g, w))
    h = mlstm_scan_ref(*args)[0]
    assert torch.isfinite(h).all()


@pytest.mark.parametrize("S", [1, L - 1, L, L + 1, 2 * L + 3, 8 * L])
def test_backward_flops_counts_the_chunkwise_products(S):
    """``kernel.backward_flops``, the operations the kernels' bound prices,
    against the products of the algebra summed over steps: the forward
    state pass over every step but the last chunk's, the reverse pass and
    the three gradient products over every step, one D^2 dot a chunk,
    and the five lower-triangular [Lc x Lc] products; at D = 256 (over
    2.5 (L + 1)) never more than the step-by-step form's 12 D^2 a step."""
    BH, D = 3, 256
    n_ck = -(-S // L)
    chunks = [min(L, S - c * L) for c in range(n_ck)]
    want = BH * (2 * D * D * (S - chunks[-1]) + 2 * D * D * S
                 + 6 * D * D * S + 2 * D * D * n_ck
                 + 5 * D * sum(n * (n + 1) for n in chunks))
    got = mlstm_kernel.backward_flops(BH, S, D)
    assert got == want
    assert got <= 12 * D * D * S * BH + 2 * D * D * n_ck * BH
