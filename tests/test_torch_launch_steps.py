"""The mesh-free half of the launch layer (``repro_torch.launch.steps``)
against ``repro.launch.steps``, and the config members it reads.

  * ``ModelConfig.subquadratic``, ``num_params()`` and ``active_params()``
    on every architecture, full and smoke; ``ASSIGNED_ARCHS`` and
    ``PAPER_ARCHS`` by equality;
  * ``adapt_for_shape``, ``pattern_len``, ``probe_config``,
    ``experts_padded`` and ``default_accum_steps`` on every architecture x
    ``SHAPES`` (meshes: none, and ``AbstractMesh`` (2, 2), (16, 16));
  * ``input_specs``, ``decode_cache_specs`` and ``abstract_params``: the
    port's ``meta`` tensors hold the reference's ``ShapeDtypeStruct``
    shapes and dtypes, leaf for leaf and path for path, on every
    architecture at smoke and full size (decode shapes adapted first);
  * ``cluster_from_mesh`` and ``resolve_launch_plan``: the reference's
    clusters and plans (findep, sequential; prefill and decode);
  * ``build``: a train, a prefill and a ``long_500k`` decode bundle at
    smoke size (f32, CPU) from the reference's weights, against the
    reference's bundles (loss and grad norm of one step at 1e-5, prefill
    logits at 1e-5 and the same greedy tokens over 8 decode steps),
    qwen2-moe-a2.7b and the adapted deepseek-v2-lite, whose ``long_500k``
    adaptation drops its MLA latent."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamW  # noqa: E402
from repro.training.optimizer import init_opt_state as jinit_opt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.training.tree import tree_leaves, tree_paths  # noqa: E402

ARCHS = configs.ALL_ARCHS
MESHES = (None, AbstractMesh((2, 2), ("data", "model")),
          AbstractMesh((16, 16), ("data", "model")))
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, smoke):
    if smoke:
        return configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    return configs.get_config(arch), jconfigs.get_config(arch)


def _same_cfg(cfg, jcfg):
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_arch_tuples_match_reference():
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert configs.PAPER_ARCHS == jconfigs.PAPER_ARCHS
    assert configs.ALL_ARCHS == jconfigs.ALL_ARCHS


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_members_match_reference(arch, smoke):
    cfg, jcfg = _pair(arch, smoke)
    _same_cfg(cfg, jcfg)
    assert cfg.subquadratic == jcfg.subquadratic
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.active_params() == jcfg.active_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_helpers_match_reference(arch):
    for smoke in (True, False):
        cfg, jcfg = _pair(arch, smoke)
        assert steps.pattern_len(cfg) == jsteps.pattern_len(jcfg)
        for units in (1, 2, 3):
            _same_cfg(steps.probe_config(cfg, units),
                      jsteps.probe_config(jcfg, units))
        for name, shape in configs.SHAPES.items():
            jshape = jconfigs.SHAPES[name]
            _same_cfg(steps.adapt_for_shape(cfg, shape),
                      jsteps.adapt_for_shape(jcfg, jshape))
            for mesh in MESHES:
                assert steps.experts_padded(cfg, mesh) == \
                    jsteps.experts_padded(jcfg, mesh)
                assert steps.default_accum_steps(cfg, shape, mesh) == \
                    jsteps.default_accum_steps(jcfg, jshape, mesh)


def _ref_leaves(tree):
    """(path, shape, dtype name) of a reference tree, in leaf order."""
    from repro.sharding.partition import _path_names
    return [(_path_names(p), tuple(x.shape), str(x.dtype)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree):
    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in tree_paths(tree)]


def _meta_only(tree):
    assert all(x.device.type == "meta" for x in tree_leaves(tree))


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, smoke):
    base, jbase = _pair(arch, smoke)
    for name, shape in configs.SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        cfg = steps.adapt_for_shape(base, shape)
        jcfg = jsteps.adapt_for_shape(jbase, jshape)
        specs = steps.input_specs(cfg, shape)
        jspecs = jsteps.input_specs(jcfg, jshape)
        assert sorted(specs) == sorted(jspecs)
        _meta_only(specs)
        for k in specs:
            assert tuple(specs[k].shape) == jspecs[k].shape, (name, k)
            assert str(specs[k].dtype) == f"torch.{jspecs[k].dtype}", k
        if shape.mode == "decode":
            model = steps.make_model(cfg, device="meta")
            jmodel = jsteps.make_model(jcfg, None, scan_layers=False)
            caches = steps.decode_cache_specs(model, cfg, shape)
            _meta_only(caches)
            assert _port_leaves(caches) == _ref_leaves(
                jsteps.decode_cache_specs(jmodel, jcfg, jshape, None))
    model = steps.make_model(base, device="meta")
    jmodel = jsteps.make_model(jbase, None, scan_layers=False)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        params = steps.abstract_params(model, dtype)
        _meta_only(params)
        assert _port_leaves(params) == _ref_leaves(
            jsteps.abstract_params(jmodel, jdtype))


def test_long_500k_drops_the_mla_latent():
    shape, jshape = configs.SHAPES["long_500k"], jconfigs.SHAPES["long_500k"]
    for smoke in (True, False):
        cfg, jcfg = _pair("deepseek-v2-lite", smoke)
        ad, jad = steps.adapt_for_shape(cfg, shape), \
            jsteps.adapt_for_shape(jcfg, jshape)
        assert (ad.attention, ad.sliding_window, ad.mla_kv_lora_rank) == \
            ("sliding", steps.LONG_CONTEXT_WINDOW, 0)
        before = {p[-2] for p, *_ in _port_leaves(steps.abstract_params(
            steps.make_model(cfg, device="meta")))}
        after = {p[-2] for p, *_ in _port_leaves(steps.abstract_params(
            steps.make_model(ad, device="meta")))}
        jafter = {p[-2] for p, *_ in _ref_leaves(jsteps.abstract_params(
            jsteps.make_model(jad, None, scan_layers=False)))}
        assert "w_dkv" in before and "w_dkv" not in after
        assert after == jafter
        # the adapted ring of a decode cache: the window, not 524288
        caches = steps.decode_cache_specs(steps.make_model(ad, device="meta"),
                                          ad, shape)
        assert caches[0]["k"].shape[1] == steps.LONG_CONTEXT_WINDOW


def test_cluster_and_launch_plans_match_reference():
    cfg, jcfg = _pair("qwen2-moe-a2.7b", True)
    meshes = [SimpleNamespace(shape={"data": 2, "model": 4}, size=8),
              SimpleNamespace(shape={"model": 8}, size=8),
              AbstractMesh((4, 4), ("data", "model"))]
    for mesh in meshes:
        assert dataclasses.asdict(steps.cluster_from_mesh(mesh)) == \
            dataclasses.asdict(jsteps.cluster_from_mesh(mesh))
    for bad in (SimpleNamespace(shape={"model": 1}, size=1),):
        with pytest.raises(ValueError, match="DEP needs"):
            steps.cluster_from_mesh(bad)
    mesh = meshes[0]
    for policy, mode, bpd in (("findep", "prefill", 4),
                              ("findep", "decode", 2),
                              ("sequential", "decode", 2),
                              ("sequential", "prefill", 4)):
        for c, jc in ((cfg, jcfg), _pair("qwen2-moe-a2.7b", False)):
            got = steps.resolve_launch_plan(c, mesh, policy, 256, mode=mode,
                                            batch_per_device=bpd)
            want = jsteps.resolve_launch_plan(jc, mesh, policy, 256,
                                              mode=mode,
                                              batch_per_device=bpd)
            assert (got.m_a, got.r1, got.m_e, got.r2, got.order) == \
                (want.m_a, want.r1, want.m_e, want.r2, want.order)
            np.testing.assert_allclose(got.makespan, want.makespan,
                                       rtol=1e-9)
    dense, jdense = _pair("qwen2-1.5b", True)
    assert steps.resolve_launch_plan(dense, mesh, "findep", 256) is None
    assert steps.resolve_launch_plan(cfg, None, "findep", 256) is None


def _weights(jmodel, seed=0):
    jp = jmodel.init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_build_train_and_prefill_bundles_match_reference():
    cfg, jcfg = _pair("qwen2-moe-a2.7b", True)
    train = ShapeConfig("train_smoke", 16, 4, "train")
    jtrain = jconfigs.base.ShapeConfig("train_smoke", 16, 4, "train")
    b = steps.build(cfg, train, dtype=torch.float32, device="cpu")
    jb = jsteps.build(jcfg, jtrain, dtype=jnp.float32, scan_layers=False)
    assert b.name == jb.name and b.accum_steps == jb.accum_steps == 1
    assert _port_leaves(b.abstract_args[0]) == _ref_leaves(
        jb.abstract_args[0])
    assert _port_leaves(b.abstract_args[1]) == _ref_leaves(
        jb.abstract_args[1])
    jp, params = _weights(jb.model)
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 16))
    _, _, m = b.step_fn(params, init_opt_state(params, AdamWConfig(
        state_dtype=torch.bfloat16)), torch.from_numpy(tok))
    _, _, jm = jax.jit(jb.step_fn)(jp, jinit_opt(jp, JAdamW(
        state_dtype=jnp.bfloat16)), jnp.asarray(tok, jnp.int32))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL)

    pre = ShapeConfig("prefill_smoke", 24, 2, "prefill")
    jpre = jconfigs.base.ShapeConfig("prefill_smoke", 24, 2, "prefill")
    b = steps.build(cfg, pre, dtype=torch.float32, device="cpu")
    jb = jsteps.build(jcfg, jpre, dtype=jnp.float32, scan_layers=False)
    assert [tuple(t.shape) for t in b.abstract_args[1:]] == \
        [t.shape for t in jb.abstract_args[1:]]
    tok = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 24))
    # the train step updated ``params`` in place: convert them anew
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    logits, _ = b.step_fn(params, torch.from_numpy(tok))
    jlogits, _ = jax.jit(jb.step_fn)(jp, jnp.asarray(tok, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    assert (logits[:, -1].argmax(-1).numpy()
            == np.asarray(jlogits)[:, -1].argmax(-1)).all()


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite"])
def test_build_long_500k_decode_matches_reference(arch):
    """The adapted smoke config's decode bundle: caches made from its
    specs (zeros), then 8 greedy serve steps fed back, token for token."""
    shape, jshape = configs.SHAPES["long_500k"], jconfigs.SHAPES["long_500k"]
    base, jbase = _pair(arch, True)
    cfg, jcfg = steps.adapt_for_shape(base, shape), \
        jsteps.adapt_for_shape(jbase, jshape)
    b = steps.build(cfg, shape, dtype=torch.float32, device="cpu")
    jb = jsteps.build(jcfg, jshape, dtype=jnp.float32, scan_layers=False)
    assert b.name == jb.name
    assert _port_leaves(b.abstract_args[2]) == _ref_leaves(
        jb.abstract_args[2])
    jp, params = _weights(jb.model)
    caches = [{k: torch.zeros(v.shape, dtype=v.dtype) for k, v in c.items()}
              for c in b.abstract_args[2]]
    jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                           jb.abstract_args[2])
    jstep = jax.jit(jb.step_fn)
    tok = torch.tensor([[7]])
    jtok = jnp.asarray([[7]], jnp.int32)
    got, want = [], []
    for _ in range(8):
        tok, caches = b.step_fn(params, tok, caches)
        jtok, jcaches = jstep(jp, jtok, jcaches)
        got.append(int(tok[0, 0]))
        want.append(int(jtok[0, 0]))
    assert got == want
    assert int(caches[0]["index"]) == int(jcaches[0]["index"]) == 8
