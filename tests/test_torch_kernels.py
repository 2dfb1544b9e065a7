"""Port parity: each kernel's plain version against the JAX package's
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and its
jnp oracle (f32, CPU), plus the wrappers' device dispatch. The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_pallas, largest_block_size)
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro.kernels.moe_gemm.kernel import moe_gemm_pallas  # noqa: E402
from repro.kernels.moe_gemm.ref import moe_gemm_ref  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels.decode_attention.ops import \
    decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gemm.ops import moe_gemm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def _randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,C,H,Kv,D,bc,lengths", [
    (3, 256, 8, 2, 32, 64, [0, 1, 256]),          # len 0 / 1 / C, g=4
    (4, 100, 4, 4, 16, 64, [0, 1, 100, 37]),      # non-tile C (bc -> 50)
    (2, 128, 6, 1, 32, 32, [77, 128]),            # g=6 over one KV head
])
def test_decode_attention_plain_matches_pallas(B, C, H, Kv, D, bc, lengths):
    rng = np.random.RandomState(0)
    q, k, v = (_randn(rng, B, H, D), _randn(rng, B, C, Kv, D),
               _randn(rng, B, C, Kv, D))
    lens = np.asarray(lengths, np.int32)
    port = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lens))
    pallas = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        bc=largest_block_size(C, bc), interpret=True)
    _close(port, pallas)
    _close(port, decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(lens)))
    assert not port[torch.from_numpy(lens == 0)].any()   # exact zeros


# ---------------------------------------------------------------------------
# grouped SwiGLU GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,C,M,H", [(2, 64, 32, 64), (3, 32, 64, 96)])
def test_moe_gemm_plain_matches_pallas(E, C, M, H):
    rng = np.random.RandomState(1)
    x = _randn(rng, E, C, M)
    wg, wu = _randn(rng, E, M, H, scale=0.2), _randn(rng, E, M, H, scale=0.2)
    wd = _randn(rng, E, H, M, scale=0.2)
    port = moe_gemm(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    jx = [jnp.asarray(a) for a in (x, wg, wu, wd)]
    _close(port, moe_gemm_pallas(*jx, bc=32, bh=32, interpret=True))
    _close(port, moe_gemm_ref(*jx))


@pytest.mark.parametrize("C", [1, 37])
def test_moe_gemm_plain_matches_oracle_at_ragged_capacity(C):
    """C that does not tile (the CUDA kernel masks it; the JAX op would
    fall back to its oracle): the plain version equals the oracle."""
    rng = np.random.RandomState(2)
    E, M, H = 3, 24, 40
    arrs = (_randn(rng, E, C, M), _randn(rng, E, M, H, scale=0.2),
            _randn(rng, E, M, H, scale=0.2), _randn(rng, E, H, M, scale=0.2))
    port = moe_gemm(*(torch.from_numpy(a) for a in arrs))
    _close(port, moe_gemm_ref(*(jnp.asarray(a) for a in arrs)))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,Kv,D,window", [
    (1, 64, 4, 2, 32, None), (2, 64, 2, 2, 16, None), (1, 64, 4, 1, 32, 16),
])
def test_flash_attention_plain_matches_pallas(B, S, H, Kv, D, window):
    rng = np.random.RandomState(3)
    q, k, v = (_randn(rng, B, S, H, D), _randn(rng, B, S, Kv, D),
               _randn(rng, B, S, Kv, D))
    port = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), window=window)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(port, flash_attention_pallas(jq, jk, jv, window=window, bq=32,
                                        bk=32, interpret=True))
    _close(port, flash_attention_ref(jq, jk, jv, window=window))


def test_flash_attention_plain_matches_oracle_at_ragged_length():
    rng = np.random.RandomState(4)
    q, k, v = (_randn(rng, 2, 50, 6, 16), _randn(rng, 2, 50, 2, 16),
               _randn(rng, 2, 50, 2, 16))
    port = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v))
    _close(port, flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v)))


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version; nothing else falls back
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", ["decode_attention", "moe_gemm",
                                  "flash_attention"])
def test_wrapper_dispatch_by_device(name):
    """A CPU call runs the plain version and counts no launch; a tensor on
    another device is refused (no fallback to the plain version)."""
    tk.reset_launch_counts()
    if name == "decode_attention":
        args = (torch.zeros(2, 4, 8), torch.zeros(2, 16, 2, 8),
                torch.zeros(2, 16, 2, 8), torch.tensor([3, 0], dtype=torch.int32))
        meta = (_meta(2, 4, 8), _meta(2, 16, 2, 8), _meta(2, 16, 2, 8),
                _meta(2, dtype=torch.int32))
        fn = decode_attention
    elif name == "moe_gemm":
        args = (torch.zeros(2, 3, 8), torch.zeros(2, 8, 4),
                torch.zeros(2, 8, 4), torch.zeros(2, 4, 8))
        meta = (_meta(2, 3, 8), _meta(2, 8, 4), _meta(2, 8, 4),
                _meta(2, 4, 8))
        fn = moe_gemm
    else:
        args = (torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32),
                torch.zeros(1, 8, 2, 32))
        meta = tuple(_meta(1, 8, 2, 32) for _ in range(3))
        fn = flash_attention
    out = fn(*args)
    assert out.device.type == "cpu"
    assert tk.launch_counts()[name] == 0
    with pytest.raises(ValueError):
        fn(*meta)
    assert tk.launch_counts()[name] == 0
