"""Port parity: the xLSTM serving path. The causal conv, the mLSTM scan's
plain version (against the reference's Pallas kernel in interpret mode and
its oracle), the mLSTM and sLSTM blocks with a non-zero incoming state,
the xlstm-1.3b smoke model's prefill and decode logits, and the serving
engine's greedy tokens under exact-length grouping all match the JAX
package (CPU, f32, smoke size).

The port runs every mLSTM block through the ``mlstm_scan`` op, where the
reference's ``apply_layer`` runs a ``lax.scan`` of the cell: the blocks'
and the model's parity below holds the two routes against each other."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.mlstm_scan.kernel import mlstm_scan_pallas  # noqa: E402
from repro.kernels.mlstm_scan.ref import \
    mlstm_scan_ref as jax_mlstm_ref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan  # noqa: E402
from repro_torch.models import build_model, layers, ssm  # noqa: E402
from repro_torch.runtime import Request, ServingEngine  # noqa: E402

ARCH = "xlstm-1.3b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np(tree))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_reference(with_state):
    rng = np.random.RandomState(0)
    p = jax_layers.conv1d_init(jax.random.PRNGKey(1), 24, 4)
    x = rng.randn(2, 7, 24).astype(np.float32)
    st = rng.randn(2, 3, 24).astype(np.float32) if with_state else None
    yj, sj = jax_layers.conv1d_apply(
        p, jnp.asarray(x), None if st is None else jnp.asarray(st))
    yt, stt = layers.conv1d_apply(
        _t(p), torch.from_numpy(x),
        None if st is None else torch.from_numpy(st))
    _close(yt, yj)
    _close(stt, sj)
    # decode-style: the carried tail continues the sequence exactly
    y1, s1 = layers.conv1d_apply(_t(p), torch.from_numpy(x[:, :4]))
    y2, _ = layers.conv1d_apply(_t(p), torch.from_numpy(x[:, 4:]), s1)
    full, _ = layers.conv1d_apply(_t(p), torch.from_numpy(x))
    _close(torch.cat([y1, y2], 1), full.numpy())


# ---------------------------------------------------------------------------
# the mLSTM scan's plain version
# ---------------------------------------------------------------------------

def _scan_inputs(B, H, S, D, seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    q = rng.randn(B, H, S, D).astype(f)
    k = (rng.randn(B, H, S, D) / np.sqrt(D)).astype(f)
    v = rng.randn(B, H, S, D).astype(f)
    ig = rng.randn(B, H, S).astype(f)
    lf = np.log(1 / (1 + np.exp(-(rng.randn(B, H, S) + 2)))).astype(f)
    C0 = (0.1 * rng.randn(B, H, D, D)).astype(f)
    n0 = (0.1 * rng.randn(B, H, D)).astype(f)
    m0 = rng.randn(B, H).astype(f)
    return q, k, v, ig, lf, C0, n0, m0


@pytest.mark.parametrize("B,H,S,D,bs", [(2, 2, 32, 16, 16),
                                        (1, 2, 13, 32, None),
                                        (3, 1, 1, 16, None)])
def test_mlstm_scan_plain_matches_reference(B, H, S, D, bs):
    """S a multiple of the Pallas block runs the reference's kernel in
    interpret mode; ragged S and S=1 (decode) run its oracle."""
    args = _scan_inputs(B, H, S, D)
    port = mlstm_scan(*(torch.from_numpy(a) for a in args))
    refs = [jax_mlstm_ref(*(jnp.asarray(a) for a in args))]
    if bs is not None:
        refs.append(mlstm_scan_pallas(*(jnp.asarray(a) for a in args),
                                      bs=bs, interpret=True))
    for ref in refs:
        for got, want in zip(port, ref):
            _close(got, want)


def test_mlstm_wrapper_dispatch_by_device():
    """A CPU call runs the plain version and counts no launch; a ``meta``
    operand takes the shapes-only branch: an empty ``meta`` output of the
    plain version's shape and dtype, no launch counted and no aten op
    dispatched (no fallback to the plain version)."""
    from repro_torch.roofline import StepCounter
    tk.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _scan_inputs(1, 2, 3, 8)]
    out = mlstm_scan(*args)
    assert out[0].shape == (1, 2, 3, 8)
    assert tk.launch_counts()["mlstm_scan"] == 0
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
    with StepCounter() as c:
        shell = mlstm_scan(*meta)
    assert [(t.device.type, t.shape, t.dtype) for t in shell] == \
        [("meta", t.shape, t.dtype) for t in out]
    assert c.counts.aten_ops == 0
    assert c.counts.kernels["mlstm_scan"]["calls"] == 1
    assert tk.launch_counts()["mlstm_scan"] == 0


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _state(rng, template):
    """A non-zero incoming state shaped like ``template`` (m stays a
    running max of log-gates: moderate values)."""
    out = {}
    for name, arr in template.items():
        a = rng.randn(*np.asarray(arr).shape).astype(np.float32)
        out[name] = a if name == "m" else 0.1 * a
    return out


@pytest.mark.parametrize("kind,S", [("mlstm", 9), ("mlstm", 1),
                                    ("slstm", 9), ("slstm", 1)])
def test_blocks_match_reference(kind, S):
    """Full-sequence apply (S=9) and single-token step (S=1) from a
    non-zero state: outputs and every final state array."""
    jcfg = jax_smoke(ARCH)
    cfg = get_smoke_config(ARCH)
    rng = np.random.RandomState(3)
    init = jax_ssm.mlstm_init if kind == "mlstm" else jax_ssm.slstm_init
    jstate_fn = (jax_ssm.mlstm_state if kind == "mlstm"
                 else jax_ssm.slstm_state)
    p = init(jax.random.PRNGKey(2), jcfg)
    state = _state(rng, jstate_fn(jcfg, 2))
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    if S == 1:
        jfn = jax_ssm.mlstm_step if kind == "mlstm" else jax_ssm.slstm_step
        tfn = ssm.mlstm_step if kind == "mlstm" else ssm.slstm_step
    else:
        jfn = jax_ssm.mlstm_apply if kind == "mlstm" else jax_ssm.slstm_apply
        tfn = ssm.mlstm_apply if kind == "mlstm" else ssm.slstm_apply
    yj, sj = jfn(p, jcfg, jnp.asarray(x),
                 {k: jnp.asarray(v) for k, v in state.items()})
    yt, st = tfn(_t(p), cfg, torch.from_numpy(x),
                 {k: torch.from_numpy(v) for k, v in state.items()})
    _close(yt, yj)
    assert set(st) == set(sj)
    for name in sj:
        assert st[name].dtype == torch.float32
        _close(st[name], sj[name])


def test_layer_kinds_and_states():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, dtype=torch.bfloat16, device="cpu")
    assert model.kinds == ("mlstm", "slstm")
    caches = model.init_cache(3, 16)
    assert set(caches[0]) == {"C", "n", "m", "conv"}
    assert set(caches[1]) == {"c", "n", "m", "h", "conv"}
    # recurrent states stay f32 whatever the model dtype
    assert all(t.dtype == torch.float32 for c in caches for t in c.values())
    # the vlm family is ported: its backbone has the dense layer kinds
    vlm = build_model(get_smoke_config("qwen2-1.5b").reduced(family="vlm"),
                      device="cpu")
    assert vlm.kinds == ("attn_mlp", "attn_mlp")


# ---------------------------------------------------------------------------
# model and engine
# ---------------------------------------------------------------------------

def test_xlstm_model_logits_match_reference():
    jm = jax_build(jax_smoke(ARCH), dtype=jnp.float32)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    tm = build_model(cfg, dtype=torch.float32, device="cpu")
    tparams = _t(jparams)
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    lj, cj = jm.prefill(jparams, jnp.asarray(toks))
    lt, ct = tm.prefill(tparams, torch.from_numpy(toks).long())
    _close(lt, lj, rtol=1e-4, atol=1e-4)
    for _ in range(4):
        nj = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
        assert np.array_equal(lt[:, -1].argmax(-1).numpy(), nj)
        lj, cj = jm.decode_step(jparams, jnp.asarray(nj[:, None]), cj)
        lt, ct = tm.decode_step(tparams, torch.from_numpy(nj[:, None]).long(),
                                ct)
        _close(lt, lj, rtol=1e-4, atol=1e-4)
    for c_t, c_j in zip(ct, cj):
        for name in c_j:
            _close(c_t[name], c_j[name], rtol=1e-4, atol=1e-4)


def _drive(eng, req_cls, prompts, max_new):
    """Submit the first request, step twice, then submit the rest: they
    land mid-flight in free slots (two share a length and prefill as one
    exact-length group; the one-token prompt reuses a freed slot's
    recurrent state, as the reference's reset_slot leaves it)."""
    reqs = [req_cls(prompt=p, max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    eng.submit(reqs[0])
    eng.step()
    eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    while eng.step() or eng.waiting:
        pass
    return reqs


def test_engine_tokens_match_reference():
    jeng = JaxEngine(jax_smoke(ARCH), num_slots=2, max_context=64,
                     dtype=jnp.float32, plan_policy=None)
    cfg = get_smoke_config(ARCH)
    teng = ServingEngine(cfg, params=_t(jeng.params), num_slots=2,
                         max_context=64, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(0, cfg.vocab_size, size=n))
               for n in (5, 9, 9, 1, 13)]
    max_new = [3, 6, 4, 3, 5]
    rj = _drive(jeng, JaxRequest, prompts, max_new)
    rt = _drive(teng, Request, prompts, max_new)
    for a, b in zip(rt, rj):
        assert a.output == b.output, (a.output, b.output)
        assert a.state.value == b.state.value
    assert teng.stats.prefill_tokens == jeng.stats.prefill_tokens
    assert teng.stats.decode_tokens == jeng.stats.decode_tokens
