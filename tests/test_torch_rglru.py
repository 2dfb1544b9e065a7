"""Port parity: the RG-LRU recurrence and block of RecurrentGemma. The
scan's plain version (against the reference's Pallas kernel in interpret
mode at tiling shapes and its oracle at ragged ones), the wrapper's
dispatch by device, and ``rglru_apply``/``rglru_step`` with a non-zero
incoming state all match the JAX package (CPU, f32, smoke size).

The port runs both the full-sequence block and the decode step through
the ``rg_lru_scan`` op, where the reference's model runs an
``associative_scan`` and a plain update: the block parity below holds the
port against both of the reference's routes (``use_kernel`` False and
True) and its step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.rg_lru.kernel import rg_lru_scan_pallas  # noqa: E402
from repro.kernels.rg_lru.ref import \
    rg_lru_scan_ref as jax_rglru_ref  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.rg_lru.ops import rg_lru_scan  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

ARCH = "recurrentgemma-9b"
# the reference's kernel tolerance (tests/test_kernels.py:86-89)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _close(port, ref):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, dtype=np.float32), **TOL)


def _scan_inputs(B, S, W, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0.8, 0.999, (B, S, W)).astype(np.float32)
    b = (0.1 * rng.randn(B, S, W)).astype(np.float32)
    h0 = rng.randn(B, W).astype(np.float32)
    return a, b, h0


# ---------------------------------------------------------------------------
# the scan's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,W,bs,bw", [(2, 256, 512, 128, 256),
                                         (1, 64, 256, 64, 128)])
def test_rg_lru_plain_matches_pallas(B, S, W, bs, bw):
    """Tiling shapes: the reference's Pallas kernel in interpret mode."""
    a, b, h0 = _scan_inputs(B, S, W)
    h, hl = rg_lru_scan(*(torch.from_numpy(x) for x in (a, b, h0)))
    hj, hlj = rg_lru_scan_pallas(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(h0), bs=bs, bw=bw,
                                 interpret=True)
    assert h.dtype == hl.dtype == torch.float32
    _close(h, hj)
    _close(hl, hlj)


@pytest.mark.parametrize("B,S,W", [(3, 37, 100), (8, 1, 64), (1, 13, 1)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rg_lru_plain_matches_oracle(B, S, W, dtype):
    """Ragged shapes (S = 1 is a decode step): the reference's oracle. The
    bf16 case hands both the same bf16 values, read as f32."""
    a, b, h0 = _scan_inputs(B, S, W, seed=1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if dtype == "bfloat16":
        ta, tb = ta.bfloat16(), tb.bfloat16()
        a, b = ta.float().numpy(), tb.float().numpy()
    h, hl = rg_lru_scan(ta, tb, torch.from_numpy(h0))
    hj, hlj = jax_rglru_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    assert h.shape == (B, S, W) and hl.shape == (B, W)
    _close(h, hj)
    _close(hl, hlj)


def test_rg_lru_wrapper_dispatch_by_device():
    """A CPU call runs the plain version and counts no launch; a ``meta``
    operand takes the shapes-only branch: an empty ``meta`` output of the
    plain version's shape and dtype, no launch counted and no aten op
    dispatched (no fallback to the plain version)."""
    from repro_torch.roofline import StepCounter
    tk.reset_launch_counts()
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 3, 8))
    h, _ = rg_lru_scan(a, b, h0)
    assert h.shape == (2, 3, 8)
    assert tk.launch_counts()["rg_lru_scan"] == 0
    meta = [torch.empty(x.shape, dtype=x.dtype, device="meta")
            for x in (a, b, h0)]
    with StepCounter() as c:
        shell = rg_lru_scan(*meta)
    assert [(t.device.type, t.shape, t.dtype) for t in shell] == \
        [("meta", t.shape, t.dtype) for t in rg_lru_scan(a, b, h0)]
    assert c.counts.aten_ops == 0
    assert c.counts.kernels["rg_lru_scan"]["calls"] == 1
    assert tk.launch_counts()["rg_lru_scan"] == 0


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _block_setup(S, seed=3):
    jcfg = jax_smoke(ARCH)
    cfg = get_smoke_config(ARCH)
    rng = np.random.RandomState(seed)
    p = jax_rglru.rglru_init(jax.random.PRNGKey(2), jcfg)
    tmpl = jax_rglru.rglru_state(jcfg, 2)
    state = {k: (0.5 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in tmpl.items()}
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    return jcfg, cfg, p, state, x


def _check_block(yt, st, yj, sj):
    _close(yt, yj)
    assert set(st) == set(sj) == {"h", "conv"}
    for name in sj:
        assert st[name].dtype == torch.float32
        _close(st[name], sj[name])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rglru_apply_matches_reference(use_kernel):
    """Full sequence from a non-zero state, against both of the
    reference's routes: the associative scan and the Pallas kernel."""
    jcfg, cfg, p, state, x = _block_setup(S=64)
    yj, sj = jax_rglru.rglru_apply(
        p, jcfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                  state.items()}, use_kernel=use_kernel)
    yt, st = rglru.rglru_apply(_t(p), cfg, torch.from_numpy(x),
                               {k: torch.from_numpy(v) for k, v in
                                state.items()})
    _check_block(yt, st, yj, sj)


def test_rglru_step_matches_reference():
    jcfg, cfg, p, state, x = _block_setup(S=1, seed=4)
    yj, sj = jax_rglru.rglru_step(p, jcfg, jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in
                                   state.items()})
    yt, st = rglru.rglru_step(_t(p), cfg, torch.from_numpy(x),
                              {k: torch.from_numpy(v) for k, v in
                               state.items()})
    _check_block(yt, st, yj, sj)


def test_rglru_steps_continue_the_sequence():
    """Decode steps after a prefill give the full sequence's outputs and
    final state: the state carries exactly what the block needs."""
    _, cfg, p, _, x = _block_setup(S=9, seed=5)
    tp, tx = _t(p), torch.from_numpy(x)
    y_full, s_full = rglru.rglru_apply(tp, cfg, tx)
    y, st = rglru.rglru_apply(tp, cfg, tx[:, :5])
    ys = [y]
    for t in range(5, 9):
        y, st = rglru.rglru_step(tp, cfg, tx[:, t:t + 1], st)
        ys.append(y)
    _close(torch.cat(ys, 1), y_full.numpy())
    for name in s_full:
        _close(st[name], s_full[name].numpy())


def test_rglru_init_shapes_and_decay_range():
    cfg = get_smoke_config(ARCH)
    jp = jax_rglru.rglru_init(jax.random.PRNGKey(0), jax_smoke(ARCH))
    gen = torch.Generator().manual_seed(0)
    p = rglru.rglru_init(gen, cfg, dtype=torch.bfloat16)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = p
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
    # lam stays f32 and puts a = sigmoid(lam)^8 inside [0.9, 0.999]
    assert p["lam"].dtype == torch.float32
    assert p["in_x"]["kernel"].dtype == torch.bfloat16
    a = torch.sigmoid(p["lam"]) ** 8
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert rglru.rglru_block_pattern(cfg) == ("rec", "attn")
    assert rglru.rglru_block_pattern(
        get_smoke_config(ARCH).reduced(num_layers=38)) == \
        jax_rglru.rglru_block_pattern(jax_smoke(ARCH).reduced(num_layers=38))
