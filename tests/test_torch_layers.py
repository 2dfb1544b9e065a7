"""Port parity: primitive layers against the JAX package (f32, CPU)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("shape", [(2, 5, 32), (1, 3, 64)])
def test_rmsnorm(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 3
    scale = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    ref = jl.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-5)
    _close(tl.rmsnorm_apply({"scale": _t(scale)}, _t(x), 1e-5), ref)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_rope_split_halves(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    pos = rng.randint(0, 500, size=(2, 7)).astype(np.int32)
    ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(tl.apply_rope(_t(x), _t(pos), theta), ref)


def test_dense_with_bias():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, 24).astype(np.float32)
    p = {"kernel": rng.randn(24, 40).astype(np.float32),
         "bias": rng.randn(40).astype(np.float32)}
    ref = jl.dense_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    _close(tl.dense_apply({k: _t(v) for k, v in p.items()}, _t(x)), ref)


def test_mlp_swiglu():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 32).astype(np.float32)
    p = {name: {"kernel": rng.randn(*shape).astype(np.float32) * 0.2}
         for name, shape in (("gate", (32, 48)), ("up", (32, 48)),
                             ("down", (48, 32)))}
    jp = {n: {"kernel": jnp.asarray(v["kernel"])} for n, v in p.items()}
    tp = {n: {"kernel": _t(v["kernel"])} for n, v in p.items()}
    _close(tl.mlp_apply(tp, _t(x)), jl.mlp_apply(jp, jnp.asarray(x)))


def test_embedding_and_tied_readout():
    rng = np.random.RandomState(4)
    table = rng.randn(50, 16).astype(np.float32)
    toks = rng.randint(0, 50, size=(2, 6)).astype(np.int32)
    ref = jl.embedding_apply({"embedding": jnp.asarray(table)},
                             jnp.asarray(toks), jnp.float32)
    out = tl.embedding_apply({"embedding": _t(table)}, _t(toks),
                             torch.float32)
    _close(out, ref)
    h = rng.randn(2, 3, 16).astype(np.float32)
    _close(tl.embedding_attend({"embedding": _t(table)}, _t(h)),
           jl.embedding_attend({"embedding": jnp.asarray(table)},
                               jnp.asarray(h)))


def test_init_distributions_match_reference_scales():
    """Model.init draws the reference's distributions: N(0, 1/in) dense
    kernels, zero biases, unit norm scales."""
    gen = torch.Generator().manual_seed(0)
    p = tl.dense_init(gen, 256, 512, bias=True)
    assert p["kernel"].shape == (256, 512)
    assert abs(float(p["kernel"].std()) - 1 / 16) < 2e-3
    assert float(p["bias"].abs().max()) == 0.0
    assert torch.equal(tl.rmsnorm_init(8, "cpu")["scale"], torch.ones(8))
