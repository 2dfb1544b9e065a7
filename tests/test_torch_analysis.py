"""The port's ``analysis/`` against the reference's: ``kernelcheck`` over
the CUDA kernels' index mirrors and ``capturelint`` in place of
``jitlint`` find no violation on the port's tree; a broken mirror (a
paged map without its table lookup, a GQA fold of ``h % Kv``, a dense map
that drops the chunk's offset, a fold without the division) gives the
same violation codes as the reference's pass on the equivalent Pallas
index map; the ledger states both passes build are the same tables; the
mLSTM backward's grid mirror (no Pallas counterpart) is clean over its
case matrix and a mirror with one slip (a ragged chunk or the columns
past D unmasked, the grid decoded the wrong way round, state rows past
D, the states laid out one chunk short) raises its code; the lint flags
host syncs, the tracer rule and unhashable key types; and ``python -m
repro_torch.analysis --check --fast`` exits 0."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analysis.kernelcheck as ref_kc  # noqa: E402
import repro.kernels.decode_attention.kernel as ref_dec  # noqa: E402
import repro.kernels.flash_attention.kernel as ref_flash  # noqa: E402
from repro_torch.analysis import PASSES, codes, run_all  # noqa: E402
from repro_torch.analysis import capturelint, kernelcheck  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as mlstm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_tree_is_clean():
    """kernelcheck and capturelint over their full case matrices, and the
    pass list the CLI runs."""
    assert PASSES == ("graphcheck", "kernelcheck", "capturelint")
    results, info = run_all(("kernelcheck", "capturelint"))
    assert results == {"kernelcheck": [], "capturelint": []}
    assert info["kernelcheck.kernel_cases"] >= 10


def test_cli_check_fast_exits_zero():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--check", "--fast", "-q"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    for name in PASSES:
        assert f"{name}: 0 violation(s)" in res.stdout
    assert "# total = 0 violation(s)" in res.stdout


def test_ledger_states_equal_the_references():
    """The port's paging manager builds the reference's tables and
    lengths from the same ledger operations."""
    for bs in (16, 48):
        port, ref = kernelcheck.ledger_states(bs), ref_kc._ledger_states(bs)
        np.testing.assert_array_equal(port._tables, ref._tables)
        assert port.lengths() == ref.lengths()


def _same_codes(port_vs, ref_vs):
    assert port_vs and ref_vs
    assert set(codes(port_vs)) == set(codes(ref_vs)), (
        codes(port_vs)[:6], codes(ref_vs)[:6])


def test_paged_map_without_table_lookup(monkeypatch):
    """Position pos read at row pos (the table skipped) in the port; block
    c streamed as page c in the reference."""
    bs = 16
    kv = kernelcheck.ledger_states(bs)
    port = kernelcheck.check_paged_rows(
        kv._tables, kv.lengths(), kv.pool.num_blocks, bs,
        rows=lambda table_row, p0, n, bs: [p0 + p for p in range(n)])
    monkeypatch.setattr(ref_dec, "paged_kv_index_map",
                        lambda bs: lambda b, kv_, c, lens, tbl: (c, 0, kv_,
                                                                 0))
    ref = ref_kc.check_paged_index_map(kv._tables, kv.lengths(),
                                       kv.pool.num_blocks, bs)
    _same_codes(port, ref)
    assert "paged-live-step-redirected" in codes(port)


def test_gqa_fold_modulo(monkeypatch):
    port = kernelcheck.check_flash_fold(2, 8, 2, fold=lambda h, H, Kv:
                                        h % Kv)
    monkeypatch.setattr(
        ref_flash, "flash_kv_index_map",
        lambda H, Kv: lambda bh, qi, ki: ((bh // H) * Kv + (bh % H) % Kv,
                                          ki, 0))
    ref = ref_kc.check_flash_index_map(2, 8, 2, 4, 4)
    _same_codes(port, ref)
    assert set(codes(port)) == {"flash-gqa-fold"}


def test_gqa_fold_without_division(monkeypatch):
    """kvh = h runs past the KV heads (range) and misreads the rest."""
    port = kernelcheck.check_flash_fold(2, 8, 2, fold=lambda h, H, Kv: h)
    monkeypatch.setattr(
        ref_flash, "flash_kv_index_map",
        lambda H, Kv: lambda bh, qi, ki: ((bh // H) * Kv + bh % H, ki, 0))
    ref = ref_kc.check_flash_index_map(2, 8, 2, 4, 4)
    _same_codes(port, ref)
    assert set(codes(port)) == {"flash-row-range", "flash-gqa-fold"}


def test_dense_map_without_chunk_offset(monkeypatch):
    """Every chunk reads the first chunk's rows; every block streams block
    0 in the reference."""
    C = 128
    lens = kernelcheck._boundary_lengths(C)
    port = kernelcheck.check_dense_rows(
        C, lens, rows=lambda b, p0, n, C: [b * C + p for p in range(n)])
    monkeypatch.setattr(ref_dec, "dense_kv_index_map",
                        lambda bc: lambda b, kv_, c, lens_: (b, 0, kv_, 0))
    ref = ref_kc.check_dense_index_map(C, dec.CHUNK, lens)
    _same_codes(port, ref)
    assert set(codes(port)) == {"dense-live-step-redirected"}


def test_tampered_tables_flag_what_the_reference_flags():
    """Row 0: a live block unallocated; row 1: a page past the pool; row 2:
    a live block on the scratch page (the mirrors unbroken)."""
    bs = 16
    tables = np.array([[3, -1, -1], [99, 2, -1], [0, 4, -1]], np.int32)
    lens = [2 * bs, bs, bs]
    port = kernelcheck.check_paged_rows(tables, lens, 8, bs)
    ref = ref_kc.check_paged_index_map(tables, lens, num_pages=8, bs=bs)
    _same_codes(port, ref)
    assert {"paged-live-step-unallocated", "paged-page-range",
            "paged-live-step-scratch"} <= set(codes(port))
    empty = np.full((3, 4), -1, np.int32)
    _same_codes(kernelcheck.check_paged_rows(empty, [20, 0, 0], 8, bs),
                ref_kc.check_paged_index_map(empty, [20, 0, 0], 8, bs))


def test_split_grid_decode_broken():
    """A split grid decoded to chunk x % 3 of row 0, head 0 repeats
    blocks and leaves live positions of the other rows unread; the
    mirror itself decodes every block once at Kv = 3."""
    vs = kernelcheck.check_dense_rows(60, [60, 3, 0], Kv=2,
                                      split=lambda x, n, B, Kv:
                                      (x % 3, 0, 0))
    assert "dense-block-identity" in codes(vs)
    assert "decode-live-position-missed" in codes(vs)
    assert kernelcheck.check_dense_rows(128, [128, 70], Kv=3) == []


# ---------------------------------------------------------------------------
# the mLSTM backward's grid (no reference counterpart: jax.grad has no
# kernel)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,S,D", kernelcheck.MLSTM_BWD_CASES)
def test_mlstm_bwd_mirror_is_clean(BH, S, D):
    """Every case of the matrix, one by one: ragged chunks (S = 1, 37, 63,
    65, 129, 130, 131 against L = 64) and D that no tile divides."""
    assert kernelcheck.check_mlstm_bwd(BH, S, D) == []


def _no_row_mask(c, j, S, D):
    L = mlstm.BACKWARD_CHUNK
    t0, col0 = c * L, j * mlstm.BACKWARD_TILE
    return range(t0, t0 + L), range(col0, min(col0 + 128, D))


def _no_col_mask(c, j, S, D):
    rows, cols = mlstm.grad_span(c, j, S, D)
    return rows, range(cols.start, cols.start + mlstm.BACKWARD_TILE)


def _chunk_major(x, y, D):
    # decodes as if the grid were chunk-minor: wrong where n_jt != n_ck
    n_jt = -(-D // mlstm.BACKWARD_TILE)
    return y, x % n_jt, x // n_jt


def _state_rows_unmasked(x, D):
    r0, c0 = mlstm.state_tile(x, D)
    return (range(r0, r0 + mlstm.BACKWARD_STATE_ROWS),
            range(c0, min(c0 + mlstm.BACKWARD_TILE, D)))


def _offset_one_chunk_short(bh, c, S, D):
    return (bh * (-(-S // mlstm.BACKWARD_CHUNK) - 1) + c) * D * D


#: (broken mirror argument, the case, the code it must raise)
BROKEN_MLSTM_BWD = {
    "ragged chunk unmasked": (dict(span=_no_row_mask), (2, 37, 200),
                              "mlstm-bwd-write-range"),
    "columns past D unmasked": (dict(span=_no_col_mask), (2, 65, 48),
                                "mlstm-bwd-write-range"),
    "grid decoded chunk-major": (dict(block=_chunk_major),
                                 (1, 131, 200),
                                 "mlstm-bwd-write-coverage"),
    "state rows past D": (dict(tile_span=_state_rows_unmasked),
                          (1, 9, 200), "mlstm-bwd-state-tiles"),
    "states one chunk short": (dict(offset=_offset_one_chunk_short),
                               (2, 131, 48), "mlstm-bwd-state-range"),
}


@pytest.mark.parametrize("broken", sorted(BROKEN_MLSTM_BWD))
def test_mlstm_bwd_broken_mirror(broken):
    """A mirror with one slip raises its code (and the sound mirror on the
    same case raises none)."""
    patch, (BH, S, D), code = BROKEN_MLSTM_BWD[broken]
    assert kernelcheck.check_mlstm_bwd(BH, S, D) == []
    assert code in codes(kernelcheck.check_mlstm_bwd(BH, S, D, **patch))


# ---------------------------------------------------------------------------
# capturelint
# ---------------------------------------------------------------------------

HOT_SRC = (
    "import numpy as np\n"
    "import torch\n"
    "\n"
    "def step(x):\n"
    "    return x.item()\n"
)


def test_item_in_a_hot_module_is_a_host_sync():
    vs = capturelint.lint_source(HOT_SRC, "models/moe.py", hot=True)
    assert codes(vs) == ["host-sync"]
    assert "models/moe.py:5" == vs[0].where and ".item()" in vs[0].message
    # the same source outside the hot modules is not scanned
    assert capturelint.lint_source(HOT_SRC, "runtime/engine.py") == []


def test_every_host_sync_family_is_flagged():
    src = ("import numpy as np\n"
           "import torch as th\n"
           "def f(x):\n"
           "    a = x.tolist()\n"
           "    b = x.cpu()\n"
           "    c = x.numpy()\n"
           "    th.cuda.synchronize()\n"
           "    d = np.asarray(x)\n"
           "    return np.array(x)\n")
    vs = capturelint.lint_source(src, "models/layers.py", hot=True)
    assert codes(vs) == ["host-sync"] * 6
    assert [int(v.where.rsplit(":", 1)[1]) for v in vs] == list(range(4, 10))


def test_allowance_names_its_function():
    """The allowance holds in the function it names and nowhere else."""
    src = ("class DepGroups:\n"
           "    @classmethod\n"
           "    def from_mesh(cls, mesh):\n"
           "        return mesh.tolist()\n"
           "    def other(self, x):\n"
           "        return x.tolist()\n")
    vs = capturelint.lint_source(src, "core/dep.py", hot=True)
    assert [v.where for v in vs] == ["core/dep.py:6"]
    for key, reason in capturelint.ALLOWED_HOST_SYNCS.items():
        assert key[0] in capturelint.HOT_MODULES and len(reason) > 20


def test_tracer_rule():
    ok = ("from repro_torch.obs.trace import active_tracer\n"
          "def walk():\n"
          "    return active_tracer()\n")
    assert capturelint.lint_source(ok, "core/dep.py",
                                   tracer_module=True) == []
    for bad in ("from repro_torch.obs.trace import active_tracer, "
                "use_tracer\n"
                "def walk(t):\n"
                "    with use_tracer(t):\n"
                "        pass\n",
                "from repro_torch.obs.trace import active_tracer\n"
                "from repro_torch.obs import trace\n"
                "def walk(t):\n"
                "    trace._ACTIVE.set(t)\n",
                "def walk():\n"
                "    from repro_torch.obs.trace import active_tracer\n"
                "    return active_tracer()\n"):
        vs = capturelint.lint_source(bad, "core/dep.py", tracer_module=True)
        assert "tracer-context-leak" in codes(vs), bad


def test_key_types():
    """The registry is clean; DevicePlacement is exempt by name (it
    compares by identity); a list field, a non-frozen class and an
    identity-compared class are flagged."""
    assert capturelint.check_static_types() == []
    from repro_torch.core.dep import DevicePlacement
    assert DevicePlacement.__dataclass_params__.eq is False
    assert ("repro_torch.core.dep", "DevicePlacement") in \
        capturelint.IDENTITY_KEYED

    @dataclasses.dataclass(frozen=True)
    class BadKey:
        xs: list

    @dataclasses.dataclass
    class NotFrozen:
        x: int = 0

    @dataclasses.dataclass(frozen=True, eq=False)
    class ByIdentity:
        x: int = 0

    vs = capturelint.check_static_types(extra=(BadKey, NotFrozen,
                                               ByIdentity))
    msgs = " | ".join(v.message for v in vs)
    assert codes(vs) == ["static-type-unhashable"] * 3
    assert "BadKey.xs" in msgs and "NotFrozen" in msgs \
        and "ByIdentity" in msgs
