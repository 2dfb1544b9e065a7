"""Port parity: the whole model. The JAX ``Model.init`` weights, converted
through ``bridge.params_from_numpy``, give the same prefill and decode
logits and the same greedy tokens (f32, CPU). The JAX side runs
``attn_impl="decode_kernel"`` (prefill through ``_sdpa``, decode through
the Pallas kernel in interpret mode); the port runs its flash prefill and
its decode kernel's plain version, so the one deliberate routing
difference is held against the reference here."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import ExecutionContext as JaxCtx  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import ExecutionContext, build_model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2-1.5b"])
def test_prefill_and_decode_logits_match(arch):
    jcfg = jax_smoke(arch)
    jm = jax_build(jcfg, ctx=JaxCtx(attn_impl="decode_kernel"),
                   dtype=jnp.float32)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    tm = build_model(cfg, ctx=ExecutionContext(attn_impl="decode_kernel"),
                     dtype=torch.float32, device="cpu")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))

    rng = np.random.RandomState(0)
    lens = [5, 16, 9]
    toks = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, cfg.vocab_size, size=n)
    last = np.asarray(lens) - 1

    lj, cj = jm.prefill(jparams, jnp.asarray(toks), seq_budget=32,
                        last_positions=jnp.asarray(last))
    lt, ct = tm.prefill(tparams, torch.from_numpy(toks).long(),
                        seq_budget=32, last_positions=torch.from_numpy(last))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)

    # continue each row from its own length, as the engine does
    idx = np.asarray(lens, np.int32)
    cj = [dict(c, index=jnp.asarray(idx)) for c in cj]
    for c in ct:
        c["index"] = torch.from_numpy(idx.copy())
    lengths = idx + 1
    for _ in range(4):
        nj = np.array(jnp.argmax(lj[:, -1], -1))       # writable copy
        nt = lt[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(nt, nj)
        lj, cj = jm.decode_step(jparams, jnp.asarray(nj[:, None], jnp.int32),
                                cj, lengths=jnp.asarray(lengths))
        lt, ct = tm.decode_step(tparams, torch.from_numpy(nj[:, None]).long(),
                                ct, lengths=torch.from_numpy(lengths))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        lengths = lengths + 1
    np.testing.assert_array_equal(lt[:, -1].argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(lj[:, -1], -1)))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_attention_impls_agree(impl):
    """Every attention route computes the same function: the port's
    "xla" (plain SDPA) and "flash" prefill equal its "decode_kernel"
    route."""
    cfg = get_smoke_config("qwen2-1.5b")
    gen = torch.Generator().manual_seed(1)
    base = build_model(cfg, ctx=ExecutionContext(attn_impl="decode_kernel"),
                       dtype=torch.float32, device="cpu")
    params = base.init(gen)
    other = build_model(cfg, ctx=ExecutionContext(attn_impl=impl),
                        dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(
        np.random.RandomState(2).randint(0, cfg.vocab_size, size=(2, 12)))
    la, ca = base.prefill(params, toks, seq_budget=16)
    lb, cb = other.prefill(params, toks, seq_budget=16)
    np.testing.assert_allclose(la.numpy(), lb.numpy(), **TOL)
    nxt = la[:, -1].argmax(-1)[:, None]
    la, _ = base.decode_step(params, nxt, ca)
    lb, _ = other.decode_step(params, nxt, cb)
    np.testing.assert_allclose(la.numpy(), lb.numpy(), **TOL)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ExecutionContext(moe_impl="dep")
    with pytest.raises(NotImplementedError):
        build_model(get_smoke_config("qwen2-1.5b").reduced(
            attention="sliding"), device="cpu").init(torch.Generator())
