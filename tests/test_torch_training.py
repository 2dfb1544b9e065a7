"""Port parity: training. The port's copy of the Markov data pipeline
gives the reference's batches bitwise; ``schedule``, ``global_norm`` and
``apply_updates`` agree with ``repro.training.optimizer`` (1e-6, f32
parameters, f32 and bf16 states, the clip active and not); checkpoints
round-trip and load across the two packages leaf for leaf; one
``make_train_step`` step agrees with the reference's jitted step on the
same weights; ``accum_steps=4`` agrees with 1; ``train()`` lowers the
loss as the reference's own test asks; the ``train_small`` entry point
runs on the CPU and writes a checkpoint that loads back."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import MarkovTextDataset as JaxMarkov  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, MarkovTextDataset  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import (AdamWConfig, OptState,  # noqa: E402
                                  apply_updates, init_opt_state,
                                  load_checkpoint, save_checkpoint, train)
from repro_torch.training.optimizer import global_norm, schedule  # noqa: E402
from repro_torch.training.tree import (tree_leaves, tree_map,  # noqa: E402
                                       tree_unflatten)

ROOT = Path(__file__).resolve().parents[1]
#: the optimizer's arithmetic is the reference's, op for op, in float32
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: with a thread per core in
    each of the suite's parallel workers, a loop of small ops waits on
    descheduled threads (the 60-step ``train()`` test took 488 s in a
    six-worker run, 9 s alone on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (11, 2)])
def test_markov_data_bitwise(seed, step):
    kw = dict(vocab_size=97, seq_len=24, batch_size=3, seed=seed)
    ours, ref = MarkovTextDataset(DataConfig(**kw)), \
        JaxMarkov(JaxDataConfig(**kw))
    np.testing.assert_array_equal(ours.sample_batch(step),
                                  ref.sample_batch(step))
    it_o, it_r = iter(ours), iter(ref)
    for _ in range(2):
        np.testing.assert_array_equal(next(it_o), next(it_r))
    assert ours.optimal_nll() == ref.optimal_nll()


def _random_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 5).astype(np.float32),
            "layers": [{"b": rng.randn(5).astype(np.float32),
                        "k": rng.randn(2, 3, 4).astype(np.float32)},
                       {"b": rng.randn(7).astype(np.float32),
                        "k": rng.randn(7, 3).astype(np.float32)}],
            "scale": rng.randn(1).astype(np.float32)}


def test_schedule_and_global_norm_match_reference():
    cfg = AdamWConfig(lr=0.7, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    jcfg = jax_opt.AdamWConfig(lr=0.7, warmup_steps=10, total_steps=100,
                               min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 140):
        np.testing.assert_allclose(
            float(schedule(cfg, torch.tensor(step, dtype=torch.int32))),
            float(jax_opt.schedule(jcfg, jnp.asarray(step, jnp.int32))),
            **OPT_TOL)
    tree = _random_tree(1)
    np.testing.assert_allclose(
        float(global_norm(params_from_numpy(tree))),
        float(jax_opt.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                         tree))), **OPT_TOL)


@pytest.mark.parametrize("clip", [1e6, 0.5], ids=["clip_off", "clip_on"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(clip, state_dtype):
    """Three steps from the same tree and gradients: parameters, both
    moments, the step and the pre-clip norm, in place in the port."""
    cfg = AdamWConfig(lr=0.05, warmup_steps=2, total_steps=10,
                      grad_clip=clip, state_dtype=getattr(torch,
                                                          state_dtype))
    jcfg = jax_opt.AdamWConfig(lr=0.05, warmup_steps=2, total_steps=10,
                               grad_clip=clip,
                               state_dtype=getattr(jnp, state_dtype))
    tree = _random_tree(0)
    params = params_from_numpy(tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    state, jstate = init_opt_state(params, cfg), \
        jax_opt.init_opt_state(jparams, jcfg)
    norms = []
    for i in range(3):
        grads = _random_tree(10 + i)
        params, state, gn = apply_updates(params, params_from_numpy(grads),
                                          state, cfg)
        jparams, jstate, jgn = jax_opt.apply_updates(
            jparams, jax.tree_util.tree_map(jnp.asarray, grads), jstate,
            jcfg)
        np.testing.assert_allclose(float(gn), float(jgn), **OPT_TOL)
        norms.append(float(gn))
    # the clip is active (the scale below 1) in the clip_on case only
    assert (min(norms) > clip) == (clip < 1)
    assert int(state.step) == int(jstate.step) == 3
    for ours, ref in ((params, jparams), (state.mu, jstate.mu),
                      (state.nu, jstate.nu)):
        for a, b in zip(tree_leaves(ours), jax.tree.leaves(ref)):
            assert a.dtype == getattr(torch, str(b.dtype))
            np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                       **OPT_TOL)


def test_apply_updates_in_place():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0)
    params = params_from_numpy(_random_tree(0))
    state = init_opt_state(params, cfg)
    ptrs = [t.data_ptr() for t in tree_leaves((params, state.mu, state.nu))]
    before = _np(params["w"]).copy()
    new_p, new_s, _ = apply_updates(params, params_from_numpy(
        _random_tree(1)), state, cfg)
    assert new_p is params
    assert [t.data_ptr() for t in tree_leaves(
        (new_p, new_s.mu, new_s.nu))] == ptrs
    assert not np.array_equal(_np(params["w"]), before)


def _ckpt_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.linspace(-3, 3, 4).to(torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32)],
            "c": {"z": torch.randn(3, 2, generator=torch.Generator()
                                   .manual_seed(0)).to(torch.bfloat16),
                  "y": torch.tensor([1.5, -2.0])}}


def _assert_same(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        a, b = np.asarray(a.float() if isinstance(a, torch.Tensor)
                          and a.dtype == torch.bfloat16 else a), \
            np.asarray(b.float() if isinstance(b, torch.Tensor)
                       and b.dtype == torch.bfloat16 else b)
        np.testing.assert_array_equal(a.astype(np.float64),
                                      b.astype(np.float64))


def test_checkpoint_roundtrip_and_across_packages(tmp_path):
    tree = _ckpt_tree()
    save_checkpoint(str(tmp_path / "port"), tree, step=7)
    back, step = load_checkpoint(str(tmp_path / "port"), tree)
    assert step == 7
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta["dtypes"] == ["float32", "bfloat16", "int32", "float32",
                              "bfloat16"]
    # the same tree in the reference: leaf order and formats agree
    jtree = jax.tree_util.tree_map(
        lambda t: jnp.asarray(_np(t)).astype(
            {torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32}.get(
                t.dtype, jnp.float32)), tree)
    jback, jstep = jax_ckpt.load_checkpoint(str(tmp_path / "port"), jtree)
    assert jstep == 7
    _assert_same(jax.tree.leaves(jback), tree_leaves(tree))
    jax_ckpt.save_checkpoint(str(tmp_path / "ref"), jtree, step=3)
    ours, step = load_checkpoint(str(tmp_path / "ref"), tree)
    assert step == 3
    for a, b in zip(tree_leaves(ours), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_refuses_other_shape(tmp_path):
    tree = _ckpt_tree()
    save_checkpoint(str(tmp_path / "ck"), tree)
    other = dict(tree, a=torch.zeros(3, 2))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path / "ck"), other)
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(str(tmp_path / "ck"), {"a": tree["a"]})


def test_tree_order_is_jax_flatten_order():
    tree = {"b": [1, {"z": 2, "a": 3}], "a": (4, None, 5),
            "c": OptState(step=6, mu=[7], nu={"q": 8})}
    assert tree_leaves(tree) == jax.tree.leaves(tree)
    back = tree_unflatten(tree, tree_leaves(tree))
    assert back == tree and isinstance(back["c"], OptState)


def _models(arch):
    jm = jax_build(jax_smoke(arch), dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(arch), dtype=torch.float32,
                     device="cpu")
    return jm, jp, tm, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp))


def test_train_step_matches_reference_jitted_step():
    """Two steps of qwen2-moe's smoke model (the capacity MoE path, the
    expert GEMM's backward) with bf16 AdamW states: loss, grad_norm and
    every parameter's update at each step. The update is held by its
    relative L2 per leaf: Adam's g / (|g| + eps) turns the gradients'
    summation-order differences near |g| ~ eps into up to a tenth of one
    step on a few single entries, which an entrywise limit would have
    to allow everywhere."""
    jm, jp, tm, tp = _models("qwen2-moe-a2.7b")
    cfg = AdamWConfig(lr=1e-3, warmup_steps=1, state_dtype=torch.bfloat16)
    jcfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=1,
                               state_dtype=jnp.bfloat16)
    rng = np.random.RandomState(0)
    step = make_train_step(tm, cfg)
    jstep = jax.jit(jax_train_step(jm, jcfg))
    state, jstate = init_opt_state(tp, cfg), jax_opt.init_opt_state(jp,
                                                                    jcfg)
    for _ in range(2):
        before = [np.asarray(b) for b in jax.tree.leaves(jp)]
        toks = rng.randint(0, tm.cfg.vocab_size, size=(2, 24)).astype(
            np.int32)
        tp, state, m = step(tp, state, torch.from_numpy(toks))
        jp, jstate, jm_ = jstep(jp, jstate, jnp.asarray(toks))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-4)
        for a, b, p0 in zip(tree_leaves(tp), jax.tree.leaves(jp), before):
            want = np.asarray(b) - p0
            err = np.linalg.norm((_np(a) - p0) - want)
            assert err <= 1e-2 * np.linalg.norm(want), \
                (a.shape, err, np.linalg.norm(want))


def test_gradient_accumulation_matches_full_batch():
    """accum_steps=4 equals the one-batch step (the reference's own
    test, on the port)."""
    cfg = get_smoke_config("qwen2-1.5b")
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    ocfg = AdamWConfig(lr=1e-3)
    tokens = torch.randint(0, cfg.vocab_size, (8, 32), generator=gen)
    outs = []
    for k in (1, 4):
        p = tree_map(torch.clone, params)
        p, _, m = make_train_step(model, ocfg, accum_steps=k)(
            p, init_opt_state(p, ocfg), tokens)
        outs.append((p, m))
    (p1, m1), (p4, m4) = outs
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-4)


def test_train_loss_decreases():
    """The reference's ``test_train_loss_decreases`` on the port."""
    cfg = get_smoke_config("qwen2-1.5b")
    res = train(cfg, steps=60, batch_size=4, seq_len=64, lr=2e-3,
                log_every=0, log_fn=lambda s: None, device="cpu")
    first = float(np.mean(res.losses[:5]))
    assert res.final_loss < first - 0.2, (first, res.final_loss)
    assert len(res.grad_norms) == 60 and res.tokens_per_s > 0


def test_train_needs_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train(get_smoke_config("qwen2-1.5b"), steps=1)


def test_train_small_cli_writes_checkpoint(tmp_path):
    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_small",
         "--device", "cpu", "--steps", "3", "--ckpt", str(ck)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "training tiny-moe" in res.stdout and "checkpoint at" in \
        res.stdout
    from repro_torch.launch.train_small import PRESETS
    model = build_model(PRESETS["tiny"], dtype=torch.float32, device="cpu")
    like = {"params": model.init(torch.Generator().manual_seed(1))}
    back, step = load_checkpoint(str(ck), like)
    assert step == 3
    assert all(torch.isfinite(t).all() for t in tree_leaves(back))
