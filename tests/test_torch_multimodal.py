"""Port parity: the vlm and audio families. The reference's parameters
(``Model.init(PRNGKey(0))`` through numpy) give the port's model the same
cross-attention, encoder self-attention, ``encode``, ``forward`` (vlm
patch embeddings in front of the tokens; audio memory), prefill plus
teacher-forced decode (the audio decoder's cross-attention at every step)
and step builders' greedy tokens as the JAX package (f32, CPU, 1e-5; the
decode-against-forward pattern at the reference test's 1e-4). The port's
encoder runs the flash kernel's plain version with ``causal=False`` and
its decode-time cross-attention the decode kernel's, where the reference
runs ``_sdpa``: every attention route is held against it. The serving
engine serves both families text-only, with the reference engine's
tokens; paged KV refuses both in both packages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL_ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import (ExecutionContext, build_model,  # noqa: E402
                                frontend_shape)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.runtime import Request, ServingEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
#: decode against forward, as the reference's own test holds it
#: (tests/test_models.py:51)
FORCED_TOL = dict(rtol=1e-4, atol=1e-4)
IMPLS = ("xla", "flash", "decode_kernel")
VLM, AUDIO = "internvl2-1b", "seamless-m4t-large-v2"
B = 2


def _t(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _models(arch, impl="decode_kernel"):
    """(reference model, its params, port model, the same params)."""
    jm = jax_build(jax_smoke(arch), dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(arch),
                     ctx=ExecutionContext(attn_impl=impl),
                     dtype=torch.float32, device="cpu")
    return jm, jp, tm, _t(jp)


def _inputs(cfg, S, seed=0):
    """Tokens [B, S] and the stub frontend's embeddings, numpy."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    shape = frontend_shape(cfg, ShapeConfig("t", S, B, "prefill"))
    return toks, rng.randn(*shape).astype(np.float32)


def test_registry_equals_reference():
    """Every architecture of the reference, in its order, with equal
    configs at full and smoke size."""
    assert ALL_ARCHS == JAX_ARCHS
    for arch in ALL_ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch)), arch
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke(arch)), arch


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_reference_params_arrive_with_port_names_and_shapes(arch):
    """``bridge.params_from_numpy`` maps the reference's ``enc_layers``,
    ``enc_norm``, ``proj`` and every decoder layer's ``ln_x`` and
    ``cross`` onto the tree the port's ``Model.init`` draws."""
    _, jp, tm, tp = _models(arch)
    own = tm.init(torch.Generator().manual_seed(0))

    def shapes(tree):
        return jax.tree_util.tree_map(lambda t: tuple(t.shape), tree)

    assert shapes(tp) == shapes(own)
    cfg = tm.cfg
    if arch == AUDIO:
        assert len(tp["enc_layers"]) == cfg.num_encoder_layers == 2
        assert set(tp["enc_layers"][0]) == {"ln1", "attn", "ln2", "mlp"}
        assert tp["enc_norm"]["scale"].shape == (cfg.d_model,)
        for layer in tp["layers"]:
            assert tuple(layer["ln_x"]["scale"].shape) == (cfg.d_model,)
            assert set(layer["cross"]) == {"wq", "wk", "wv", "wo"}
            assert "bias" not in layer["cross"]["wq"]
        assert "proj" not in tp
    else:
        assert tuple(tp["proj"]["kernel"].shape) == (cfg.d_model,
                                                     cfg.d_model)
        assert "enc_layers" not in tp
        assert all("cross" not in layer for layer in tp["layers"])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("Sq", [1, 5])
def test_cross_attention_matches_reference(impl, Sq, monkeypatch):
    """q from the decoder, k/v from the memory (Sk = 8), no RoPE, every
    position attended: one query a row under "decode_kernel" is one call
    of the decode kernel's wrapper over the memory's 8 positions with
    every length 8, the rest the plain SDPA."""
    calls = []
    wrapped = attn.dec_ops.decode_attention

    def spy(q, k, v, lengths):
        calls.append((k.shape[1], lengths.tolist()))
        return wrapped(q, k, v, lengths)

    monkeypatch.setattr(attn.dec_ops, "decode_attention", spy)
    cfg = get_smoke_config(AUDIO)
    jp = jax_attn.cross_attention_init(jax.random.PRNGKey(3),
                                       jax_smoke(AUDIO))
    rng = np.random.RandomState(1)
    x = rng.randn(B, Sq, cfg.d_model).astype(np.float32)
    mem = rng.randn(B, 8, cfg.d_model).astype(np.float32)
    want = jax_attn.cross_attention_apply(jp, jax_smoke(AUDIO),
                                          jnp.asarray(x), jnp.asarray(mem))
    got = attn.cross_attention_apply(_t(jp), cfg, torch.from_numpy(x),
                                     torch.from_numpy(mem), impl=impl)
    _close(got, want)
    kernel = impl == "decode_kernel" and Sq == 1
    assert calls == ([(8, [8] * B)] if kernel else [])


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_self_attention_matches_reference(impl):
    """Bidirectional, with RoPE: "flash" and "decode_kernel" run the
    flash kernel's plain version with ``causal=False``."""
    cfg = dataclasses.replace(get_smoke_config(AUDIO), attention="full")
    jcfg = dataclasses.replace(jax_smoke(AUDIO), attention="full")
    jp = jax_attn.attention_init(jax.random.PRNGKey(4), jcfg)
    S = 8
    h = np.random.RandomState(2).randn(B, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    want = jax_tf._encoder_self_attention(jp, jcfg, jnp.asarray(h),
                                          jnp.asarray(pos))
    got = attn.encoder_self_attention(_t(jp), cfg, torch.from_numpy(h),
                                      torch.from_numpy(pos.copy()),
                                      impl=impl)
    _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_reference(impl):
    jm, jp, tm, tp = _models(AUDIO, impl)
    _, frames = _inputs(tm.cfg, 16)
    _close(tm.encode(tp, torch.from_numpy(frames)),
           jm.encode(jp, jnp.asarray(frames)))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_matches_reference(arch):
    """All logits [B, P+S, V] and the aux loss: vlm with its patch
    embeddings, audio with the memory given and with the frames encoded
    inside ``forward``."""
    jm, jp, tm, tp = _models(arch)
    toks, extra = _inputs(tm.cfg, 12)
    if arch == AUDIO:
        mem = jm.encode(jp, jnp.asarray(extra))
        lj, _, aj = jm.forward(jp, jnp.asarray(toks), memory=mem)
        lt, at = tm.forward(tp, torch.from_numpy(toks),
                            memory=torch.from_numpy(np.array(mem)))
        _close(lt, lj)
        lt, _ = tm.forward(tp, torch.from_numpy(toks),
                           extra_embeds=torch.from_numpy(extra))
    else:
        lj, _, aj = jm.forward(jp, jnp.asarray(toks),
                               extra_embeds=jnp.asarray(extra))
        lt, at = tm.forward(tp, torch.from_numpy(toks),
                            extra_embeds=torch.from_numpy(extra))
        assert lt.shape == (B, extra.shape[1] + 12, tm.cfg.vocab_size)
    assert lt.dtype == torch.float32
    _close(lt, lj)
    _close(at, aj)


@pytest.mark.parametrize("impl", ["xla", "decode_kernel"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_prefill_then_teacher_forced_decode_match_forward(arch, impl):
    """The reference test's pattern (tests/test_models.py:30-51): prefill
    on half of the tokens (vlm: behind its patch embeddings, the cache
    budget and the last position offset by P; audio: with the memory),
    then teacher-forced decode steps (audio: cross-attention over the
    memory at every step), each step's logits against the reference's
    ``forward`` over the whole sequence."""
    jm, jp, tm, tp = _models(arch, impl)
    S, half = 16, 8
    toks, extra = _inputs(tm.cfg, S)
    mem = mem_t = None
    ee = ee_t = None
    if arch == AUDIO:
        mem = jm.encode(jp, jnp.asarray(extra))
        mem_t = torch.from_numpy(np.array(mem))
    else:
        ee, ee_t = jnp.asarray(extra), torch.from_numpy(extra)
    full, _, _ = jm.forward(jp, jnp.asarray(toks), extra_embeds=ee,
                            memory=mem)
    off = extra.shape[1] if arch == VLM else 0
    tt = torch.from_numpy(toks)
    lg, caches = tm.prefill(tp, tt[:, :half], extra_embeds=ee_t,
                            memory=mem_t, seq_budget=S)
    assert caches[0]["k"].shape[1] == S + off
    _close(lg[:, -1], full[:, half - 1 + off], **FORCED_TOL)
    # the same last logits through last_positions, offset by P
    lp, _ = tm.prefill(tp, tt[:, :half], extra_embeds=ee_t, memory=mem_t,
                       seq_budget=S,
                       last_positions=torch.full((B,), half - 1))
    _close(lp, lg.numpy())
    for t in range(half, S):
        lg, caches = tm.decode_step(tp, tt[:, t:t + 1], caches,
                                    memory=mem_t)
        _close(lg[:, 0], full[:, t + off], **FORCED_TOL)


def _with_room(caches, n, pad):
    """Each attention cache with ``n`` zero positions after its own: the
    step builders' prefill fills caches of the prompt's length."""
    return [dict(c, k=pad(c["k"], n), v=pad(c["v"], n)) for c in caches]


def _pad_jax(x, n):
    return jnp.pad(x, ((0, 0), (0, n), (0, 0), (0, 0)))


def _pad_torch(x, n):
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_step_builders_greedy_tokens_match_reference(arch):
    """``make_prefill_step`` (audio: encode, then prefill with the memory;
    vlm: the patch embeddings in front) and 6 ``make_serve_step``s give
    the reference's greedy tokens; the frontend's stub inputs have
    ``frontend_shape``."""
    jm, jp, tm, tp = _models(arch)
    toks, extra = _inputs(tm.cfg, 8)
    jl, jc = jax_steps.make_prefill_step(jm)(jp, jnp.asarray(toks),
                                             jnp.asarray(extra))
    tl, tc = steps.make_prefill_step(tm)(tp, torch.from_numpy(toks),
                                         torch.from_numpy(extra))
    _close(tl, jl)
    mem = jm.encode(jp, jnp.asarray(extra)) if arch == AUDIO else None
    mem_t = torch.from_numpy(np.array(mem)) if arch == AUDIO else None
    jc, tc = _with_room(jc, 6, _pad_jax), _with_room(tc, 6, _pad_torch)
    jnext = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    tnext = tl[:, -1].argmax(-1)[:, None]
    jserve, tserve = jax_steps.make_serve_step(jm), \
        steps.make_serve_step(tm)
    jtoks, ttoks = [], []
    for _ in range(6):
        jnext, jc = jserve(jp, jnext, jc, memory=mem)
        tnext, tc = tserve(tp, tnext, tc, memory=mem_t)
        jtoks.append(np.asarray(jnext)[:, 0].tolist())
        ttoks.append(tnext[:, 0].tolist())
    assert ttoks == jtoks
    assert tnext.dtype == torch.int64


def test_frontend_inputs():
    """N(0, 1) of ``frontend_shape`` from the given generator, in the asked
    dtype, None for a text-only family; no device means the card."""
    for arch, n in ((VLM, 16), (AUDIO, 8)):
        cfg = get_smoke_config(arch)
        a = steps.frontend_inputs(cfg, 3, 32, torch.Generator().manual_seed(
            5), device="cpu", dtype=torch.float32)
        b = steps.frontend_inputs(cfg, 3, 32, torch.Generator().manual_seed(
            5), device="cpu", dtype=torch.float32)
        assert a.shape == (3, n, cfg.d_model) and torch.equal(a, b)
        assert abs(float(a.std()) - 1.0) < 0.1
    assert steps.frontend_inputs(get_smoke_config("qwen2-1.5b"), 3, 32,
                                 torch.Generator(), device="cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            steps.frontend_inputs(get_smoke_config(VLM), 1, 8,
                                  torch.Generator())


def _drive(eng, req_cls, prompts, max_new):
    reqs = [req_cls(prompt=p, max_new_tokens=n)
            for p, n in zip(prompts, max_new)]
    for r in reqs:
        eng.submit(r)
    while eng.step() or eng.waiting:
        pass
    return reqs


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_engine_serves_text_only_like_reference(arch):
    """Both engines serve the family text-only (the audio decoder skips
    cross-attention without memory) with the same greedy tokens; paged KV
    refuses the family in both packages."""
    jeng = JaxEngine(jax_smoke(arch), num_slots=2, max_context=32,
                     dtype=jnp.float32, plan_policy=None)
    cfg = get_smoke_config(arch)
    teng = ServingEngine(cfg, params=_t(jeng.params), num_slots=2,
                         max_context=32, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(0, cfg.vocab_size, size=n))
               for n in (5, 11, 3)]
    max_new = [6, 4, 5]
    rj = _drive(jeng, JaxRequest, prompts, max_new)
    rt = _drive(teng, Request, prompts, max_new)
    assert [r.output for r in rt] == [r.output for r in rj]
    assert all(len(r.output) == n for r, n in zip(rt, max_new))
    with pytest.raises(ValueError, match="paged"):
        JaxEngine(jax_smoke(arch), num_slots=2, max_context=32,
                  dtype=jnp.float32, plan_policy=None, kv_layout="paged")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg, num_slots=2, max_context=32,
                      dtype=torch.float32, device="cpu", kv_layout="paged")
