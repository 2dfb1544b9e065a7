"""Port parity: ``Model.loss`` and its gradients. The reference's
parameters (``Model.init(PRNGKey(0))`` through numpy) give the port's
smoke model the reference's loss (f32, CPU, ``ce_chunk`` = 12 over 31
targets: the padded, masked last chunk) and every gradient leaf of
``jax.grad`` (relative L2 per leaf), the recurrent family through the
mLSTM scan's backward. The expert GEMM's backward against autograd of
its plain version, remat on and off, the refusals of the kernels without
a backward (the attention kernels), and the DEP layer's gradients.
``test_torch_loss_grads_multimodal.py`` runs the same checks on the vlm,
audio and hybrid families; ``test_torch_scan_grads.py`` holds the scans'
backwards themselves."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import kernels as kernel_lib  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.dep import moe_apply_dep  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_attention_paged)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gemm.ops import (  # noqa: E402
    MoEGemmFunction, moe_gemm, moe_gemm_backward)
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import (ExecutionContext, build_model,  # noqa: E402
                                frontend_shape)
from repro_torch.training.tree import tree_leaves  # noqa: E402

B, S, CE_CHUNK = 2, 32, 12
#: the loss: f32, the same reductions in another order
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
#: each gradient leaf's relative L2 against jax.grad's (the worst read
#: 2.4e-6 over the five families that trained before the scans had a
#: backward)
GRAD_REL_L2 = 1e-4
#: the families of this file, whose loss and gradients the port computes
#: on both devices
TRAINS = ("qwen2-moe-a2.7b", "qwen2-1.5b", "deepseek-v2-lite",
          "xlstm-1.3b")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: with a thread per core in
    each of the suite's parallel workers, a loop of small ops waits on
    descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg):
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    shape = frontend_shape(cfg, ShapeConfig("t", S, B, "prefill"))
    return toks, (rng.randn(*shape).astype(np.float32) if shape else None)


@functools.lru_cache(maxsize=None)
def reference(arch: str, with_grads: bool):
    """(numpy params, tokens, extra, loss, numpy gradient leaves or
    None): the reference's ``value_and_grad`` of ``Model.loss``, computed
    once per family and module."""
    jm = jax_build(jax_smoke(arch), dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    toks, extra = _inputs(jm.cfg)
    ex = None if extra is None else jnp.asarray(extra)

    def loss(p):
        return jm.loss(p, jnp.asarray(toks), extra_embeds=ex,
                       ce_chunk=CE_CHUNK)

    if with_grads:
        value, grads = jax.value_and_grad(loss)(jp)
        grads = [np.asarray(g) for g in jax.tree.leaves(grads)]
    else:
        value, grads = loss(jp), None
    return (jax.tree_util.tree_map(np.asarray, jp), toks, extra,
            float(value), grads)


def port_model(arch: str, **ctx):
    return build_model(get_smoke_config(arch),
                       ctx=ExecutionContext(**ctx), dtype=torch.float32,
                       device="cpu")


def check_loss(arch: str) -> None:
    params, toks, extra, want, _ = reference(arch, True)
    model = port_model(arch)
    with torch.no_grad():
        got = model.loss(params_from_numpy(params), torch.from_numpy(toks),
                         extra_embeds=None if extra is None
                         else torch.from_numpy(extra), ce_chunk=CE_CHUNK)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, **LOSS_TOL)


def check_grads(arch: str) -> None:
    params, toks, extra, want_loss, want = reference(arch, True)
    model = port_model(arch)
    tp = params_from_numpy(params)
    loss, grads = loss_and_grads(
        model, tp, torch.from_numpy(toks),
        None if extra is None else torch.from_numpy(extra),
        ce_chunk=CE_CHUNK)
    np.testing.assert_allclose(float(loss), want_loss, **LOSS_TOL)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        err = np.linalg.norm(g.numpy() - w)
        assert err <= GRAD_REL_L2 * np.linalg.norm(w), \
            (w.shape, err, np.linalg.norm(w))
    # the parameters themselves are left as they were
    assert not any(t.requires_grad for t in tree_leaves(tp))


@pytest.mark.parametrize("arch", TRAINS)
def test_loss_matches_reference(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", TRAINS)
def test_gradients_match_jax_grad(arch):
    check_grads(arch)


# ---------------------------------------------------------------------------
# the expert GEMM's backward
# ---------------------------------------------------------------------------

def _gemm_inputs(E=3, C=5, M=16, H=24, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to(dtype)

    return (r(E, C, M), r(E, M, H, s=M ** -0.5), r(E, M, H, s=M ** -0.5),
            r(E, H, M, s=H ** -0.5), r(E, C, M))


def _autograd_ref(x, wg, wu, wd, dy):
    ops = [t.detach().float().requires_grad_() for t in (x, wg, wu, wd)]
    y = moe_gemm_ref(*ops)
    return torch.autograd.grad(y, ops, dy.float())


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-6),
                                         (torch.bfloat16, 1e-2)])
def test_moe_gemm_backward_matches_autograd_of_plain(dtype, limit):
    """dx, dWg, dWu, dWd against autograd of ``moe_gemm_ref`` in f32 on
    the same (rounded) inputs; bf16 rounds g, u and the elementwise
    terms before each product. A backward without the silu' term fails
    the same limit."""
    x, wg, wu, wd, dy = _gemm_inputs(dtype=dtype)
    got = moe_gemm_backward(x, wg, wu, wd, dy)
    want = _autograd_ref(x, wg, wu, wd, dy)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel_l2(g, w) <= limit, _rel_l2(g, w)
    # control: silu'(g) replaced by sigmoid(g) breaks dWg and dx
    xf, wgf, wuf, wdf, dyf = (t.float() for t in (x, wg, wu, wd, dy))
    g_ = torch.bmm(xf, wgf)
    dh = torch.bmm(dyf, wdf.transpose(1, 2))
    wrong = torch.bmm(xf.transpose(1, 2),
                      dh * torch.bmm(xf, wuf) * torch.sigmoid(g_))
    assert _rel_l2(wrong, want[1]) > 10 * limit


def test_moe_gemm_function_through_the_wrapper():
    """Under grad the wrapper takes the autograd Function, whose gradients
    are autograd of the plain version; under no_grad, or with no operand
    requiring a gradient, the plain call (no graph)."""
    x, wg, wu, wd, dy = _gemm_inputs(seed=1)
    ops = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
    y = moe_gemm(*ops)
    assert y.grad_fn is not None and "MoEGemmFunction" in \
        type(y.grad_fn).__name__
    torch.testing.assert_close(y, moe_gemm_ref(x, wg, wu, wd))
    got = torch.autograd.grad(y, ops, dy)
    for g, w in zip(got, _autograd_ref(x, wg, wu, wd, dy)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        assert moe_gemm(*ops).grad_fn is None
    assert moe_gemm(x, wg, wu, wd).grad_fn is None
    # an operand that needs no gradient gets none
    y = MoEGemmFunction.apply(x, *ops[1:])
    assert len(torch.autograd.grad(y.sum(), ops[1:])) == 3


def test_remat_gives_equal_gradients():
    """``ExecutionContext(remat=True)`` checkpoints each layer: the same
    loss and gradients (the recomputed forward is the same arithmetic)."""
    params, toks, _, _, _ = reference("qwen2-moe-a2.7b", True)
    out = []
    for remat in (False, True):
        out.append(loss_and_grads(port_model("qwen2-moe-a2.7b", remat=remat),
                                  params_from_numpy(params),
                                  torch.from_numpy(toks), ce_chunk=CE_CHUNK))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_loss_and_grads_accumulates_in_accum_dtype():
    """Four micro-batches of the dense smoke model: the loss and gradients
    of the whole batch (the reference's scan divides the f32 sum)."""
    cfg = get_smoke_config("qwen2-1.5b")
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(1))
    l1, g1 = loss_and_grads(model, params, toks)
    l4, g4 = loss_and_grads(model, params, toks, accum_steps=4)
    torch.testing.assert_close(l4, l1, rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(g4), tree_leaves(g1)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _refusal_calls():
    r = functools.partial(torch.randn, generator=torch.Generator()
                          .manual_seed(0))
    q, kc = r(2, 4, 8), r(2, 6, 2, 8)
    lengths = torch.tensor([3, 6], dtype=torch.int32)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    pages = r(4, 3, 2, 8)
    qs = r(1, 4, 2, 8)
    return {
        "decode_attention": (decode_attention, (q, kc, kc.clone(), lengths)),
        "decode_attention_paged": (decode_attention_paged,
                                   (q, pages, pages.clone(), lengths,
                                    table)),
        "flash_attention": (flash_attention, (qs, qs.clone(), qs.clone())),
    }


@pytest.mark.parametrize("name", ["decode_attention",
                                  "decode_attention_paged",
                                  "flash_attention"])
def test_kernel_without_backward_refuses_grad(name):
    """Each wrapper without a backward (the attention kernels) raises,
    naming itself and the reference's way to train, when grad mode is on
    and an operand requires a gradient; it runs under no_grad and on
    operands that need none."""
    fn, args = _refusal_calls()[name]
    fn(*args)
    first = args[0].clone().requires_grad_()
    with torch.no_grad():
        fn(first, *args[1:])
    with pytest.raises(RuntimeError, match=rf"{name}: no backward: .*"
                       r"the reference trains with attn_impl='xla'"):
        fn(first, *args[1:])
    with pytest.raises(RuntimeError, match=f"{name}: no backward"):
        kernel_lib.refuse_grad(name, None, first)


def test_flash_and_dep_paths_refuse_in_a_model():
    """The flash route under autograd raises at its first attention layer
    (train with attn_impl='xla'). The DEP layer no longer refuses: its
    exchanges are differentiable, and on a gloo group of one rank
    ``moe_apply_dep``'s output and gradients (input, router, experts,
    shared) equal the capacity path's at the same capacity (f32, 1e-6;
    the sharded walk is held in ``test_torch_sharded_train.py``)."""
    params, toks, _, _, _ = reference("qwen2-moe-a2.7b", True)
    model = port_model("qwen2-moe-a2.7b", attn_impl="flash")
    with pytest.raises(RuntimeError, match="flash_attention: no backward"):
        loss_and_grads(model, params_from_numpy(params),
                       torch.from_numpy(toks))
    from repro_torch.core.dep import DepGroups
    from repro_torch.models.moe import moe_apply_capacity
    groups = DepGroups.single("gloo")
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    x0 = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                     .manual_seed(0))
    outs = []
    for dep_path in (True, False):
        layer = params_from_numpy(params["layers"][0]["moe"])
        leaves = [t.requires_grad_() for t in tree_leaves(layer)]
        x = x0.clone().requires_grad_()
        if dep_path:
            y, aux = moe_apply_dep(layer, x, cfg.moe, groups, sequence=True,
                                   batch_sharded=False)
        else:
            y, aux = moe_apply_capacity(layer, x, cfg.moe)
        grads = torch.autograd.grad((y * y).sum() + aux, [x] + leaves)
        outs.append([y.detach()] + list(grads))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert torch.isfinite(got).all()
