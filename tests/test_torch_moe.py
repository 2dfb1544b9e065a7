"""Port parity: MoE routing, capacity dispatch (same slots, same drop set),
combine and the capacity/dense layers against the JAX package (f32, CPU)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(T=24, seed=0):
    jcfg = jax_smoke("qwen2-moe-a2.7b")
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.moe)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.RandomState(seed).randn(T, cfg.d_model).astype(np.float32)
    return cfg, jcfg, jp, tp, x


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_route_topk_matches():
    cfg, jcfg, jp, tp, x = _setup()
    r_j = jmoe.route_topk(jp["router"], jnp.asarray(x), jcfg.moe)
    r_t = tmoe.route_topk(tp["router"], torch.from_numpy(x), cfg.moe)
    np.testing.assert_array_equal(_np(r_t.experts), _np(r_j.experts))
    np.testing.assert_allclose(_np(r_t.weights), _np(r_j.weights), **TOL)
    np.testing.assert_allclose(_np(r_t.probs), _np(r_j.probs), **TOL)


@pytest.mark.parametrize("capacity", [2, 5, 64])
def test_dispatch_same_slots_and_drop_set(capacity):
    """Small capacities force overflow: the kept/dropped assignments, their
    slots and the buffers must equal the reference's exactly."""
    cfg, jcfg, jp, tp, x = _setup(T=32, seed=1)
    d_j = jmoe.moe_dispatch(jp, jnp.asarray(x), jcfg.moe, capacity)
    d_t = tmoe.moe_dispatch(tp, torch.from_numpy(x), cfg.moe, capacity)
    np.testing.assert_array_equal(_np(d_t.experts), _np(d_j.experts))
    np.testing.assert_array_equal(_np(d_t.slot), _np(d_j.slot))
    assert int(d_t.dropped) == int(d_j.dropped)
    if capacity < 8:
        assert int(d_t.dropped) > 0          # the overflow really happened
    np.testing.assert_array_equal(_np(d_t.load), _np(d_j.load))
    np.testing.assert_allclose(_np(d_t.combine), _np(d_j.combine), **TOL)
    np.testing.assert_allclose(_np(d_t.buffers), _np(d_j.buffers), **TOL)
    np.testing.assert_allclose(float(d_t.aux), float(d_j.aux), **TOL)

    rng = np.random.RandomState(2)
    out = rng.randn(*d_t.buffers.shape).astype(np.float32)
    y_j = jmoe.moe_combine(d_j, jnp.asarray(out), x.shape[0], jnp.float32)
    y_t = tmoe.moe_combine(d_t, torch.from_numpy(out), x.shape[0],
                           torch.float32)
    np.testing.assert_allclose(_np(y_t), _np(y_j), **TOL)


@pytest.mark.parametrize("tokens", [1, 8, 100])
def test_expert_capacity_matches(tokens):
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    jcfg = jax_smoke("qwen2-moe-a2.7b")
    for mult in (1, 4):
        assert tmoe.expert_capacity(tokens, cfg.moe, multiple_of=mult) == \
            jmoe.expert_capacity(tokens, jcfg.moe, multiple_of=mult)


@pytest.mark.parametrize("path", ["capacity", "dense"])
def test_moe_layer_matches(path):
    cfg, jcfg, jp, tp, x = _setup(T=24, seed=3)
    xs = x.reshape(2, 12, -1)
    if path == "capacity":
        y_j, aux_j, st_j = jmoe.moe_apply_capacity(
            jp, jnp.asarray(xs), jcfg.moe, return_stats=True)
        y_t, aux_t, st_t = tmoe.moe_apply_capacity(
            tp, torch.from_numpy(xs), cfg.moe, return_stats=True)
    else:
        y_j, aux_j, st_j = jmoe.moe_apply_dense(
            jp, jnp.asarray(xs), jcfg.moe, return_stats=True)
        y_t, aux_t, st_t = tmoe.moe_apply_dense(
            tp, torch.from_numpy(xs), cfg.moe, return_stats=True)
    np.testing.assert_allclose(_np(y_t), _np(y_j), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    np.testing.assert_array_equal(_np(st_t.load), _np(st_j.load))
    assert int(st_t.dropped) == int(st_j.dropped)


def test_route_topk_masks_padded_experts():
    """Experts padded past num_experts get logits of -1e30 and so no
    tokens, as in the reference."""
    cfg, jcfg, _, _, x = _setup(T=16, seed=4)
    E_pad = cfg.moe.num_experts + 2
    jp = jmoe.moe_init(jax.random.PRNGKey(4), jcfg.d_model, jcfg.moe, E_pad)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    r_j = jmoe.route_topk(jp["router"], jnp.asarray(x), jcfg.moe, E_pad)
    r_t = tmoe.route_topk(tp["router"], torch.from_numpy(x), cfg.moe, E_pad)
    np.testing.assert_array_equal(_np(r_t.experts), _np(r_j.experts))
    assert int(r_t.experts.max()) < cfg.moe.num_experts
    np.testing.assert_allclose(_np(r_t.probs), _np(r_j.probs), **TOL)
