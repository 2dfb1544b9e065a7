"""The port's step counter and roofline (``repro_torch.roofline``) and the
kernel wrappers' work formulas, on the CPU at smoke size.

  * each kernel's ``*_work`` against an independent count: the attended
    (query, key) pairs of causal, windowed and bidirectional masks
    counted from the mask itself, the ragged rows' positions and live
    pages counted row by row, 6·E·C·M·H; a ``meta`` operand counts every
    row at the cache's capacity;
  * one smoke step of each kind counted on the CPU (the plain versions)
    and on ``meta`` from the same bundle: equal FLOPs, bytes, kernel
    work and peak live bytes (prefill, a decode step at a full cache,
    a train step; every kernel family);
  * the wire formulas against the reference's ``parse_collectives`` on
    the HLO lines of ``tests/test_roofline.py``, both directly and
    through the counter's ``c10d`` path on a fake process group (in a
    subprocess);
  * ``model_flops`` against the reference's on every architecture and
    shape;
  * the counter's own rules: a view moves no bytes, a matmul counts
    2·m·n·k in its dtype, a gather reads only its rows.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.roofline.analysis import model_flops as jax_model_flops  # noqa
from repro.roofline.analysis import parse_collectives  # noqa: E402

from repro_torch import roofline  # noqa: E402
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.rg_lru import ops as rglru_ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.roofline import StepCounter  # noqa: E402
from repro_torch.training.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# (a) each kernel's work against an independent count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,causal,window", [(37, True, None), (64, True, 16),
                                             (50, True, 7), (33, False, None),
                                             (40, False, 9), (8, True, 100)])
def test_flash_work_counts_attended_pairs(S, causal, window):
    pos = np.arange(S)
    mask = np.ones((S, S), bool)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    B, H, Kv, D = 2, 6, 2, 16
    q, k = _meta(B, S, H, D), _meta(B, S, Kv, D)
    flops, nbytes = flash_ops.flash_attention_work(q, k, k, causal, window)
    assert flops == 4.0 * B * H * D * int(mask.sum())
    assert nbytes == (2 * B * S * H * D + 2 * B * S * Kv * D) * 4


def test_decode_work_counts_each_row_at_its_length():
    B, H, Kv, D, C = 5, 8, 2, 16, 40
    lengths = torch.tensor([0, 1, 40, 57, 13], dtype=torch.int32)
    q, k = torch.zeros(B, H, D, dtype=torch.bfloat16), \
        torch.zeros(B, C, Kv, D, dtype=torch.bfloat16)
    tokens = sum(min(max(int(n), 0), C) for n in lengths)
    flops, nbytes = dec_ops.decode_attention_work(q, k, k, lengths)
    assert flops == 4.0 * tokens * H * D
    assert nbytes == (2 * B * H * D + 2 * tokens * Kv * D) * 2 + 4 * B
    # on meta the lengths are unknown: every row at the capacity
    fm, bm = dec_ops.decode_attention_work(
        _meta(B, H, D), _meta(B, C, Kv, D), _meta(B, C, Kv, D),
        _meta(B, dtype=torch.int32))
    assert fm == 4.0 * B * C * H * D
    assert bm == (2 * B * H * D + 2 * B * C * Kv * D) * 4 + 4 * B


def test_paged_decode_work_counts_live_pages():
    B, H, Kv, D, bs, nb = 4, 4, 2, 8, 16, 5
    lengths = torch.tensor([0, 16, 17, 200], dtype=torch.int32)
    q = torch.zeros(B, H, D)
    pages = torch.zeros(9, bs, Kv, D)
    table = torch.zeros(B, nb, dtype=torch.int32)
    lens = [min(int(n), nb * bs) for n in lengths]
    live = sum((n + bs - 1) // bs for n in lens)
    flops, nbytes = dec_ops.decode_attention_paged_work(q, pages, pages,
                                                        lengths, table)
    assert flops == 4.0 * sum(lens) * H * D
    assert nbytes == (2 * B * H * D + 2 * sum(lens) * Kv * D) * 4 \
        + 4 * B + 4 * live


def test_moe_gemm_mlstm_rglru_work():
    E, C, M, H = 3, 5, 16, 24
    flops, nbytes = gemm_ops.moe_gemm_work(
        _meta(E, C, M, dtype=torch.bfloat16), _meta(E, M, H),
        _meta(E, M, H), _meta(E, H, M))
    assert flops == 6.0 * E * C * M * H
    assert nbytes == (2 * E * C * M + 3 * E * M * H) * 2
    B, Hh, S, D = 2, 3, 7, 8
    q = _meta(B, Hh, S, D)
    flops, nbytes = mlstm_ops.mlstm_scan_work(
        q, q, q, _meta(B, Hh, S), _meta(B, Hh, S), _meta(B, Hh, D, D),
        _meta(B, Hh, D), _meta(B, Hh))
    # per step and head: the D x D state update and the readout
    assert flops == B * Hh * S * (2 * D * D + 2 * D * D)
    # q, k, v, h; the two gates; C, n, m in and out (f32)
    assert nbytes == 4 * (4 * B * Hh * S * D + 2 * B * Hh * S
                          + 2 * B * Hh * D * D + 2 * B * Hh * D + 2 * B * Hh)
    a = _meta(2, 9, 12, dtype=torch.bfloat16)
    flops, nbytes = rglru_ops.rg_lru_scan_work(a, a, _meta(2, 12))
    assert flops == 2.0 * 2 * 9 * 12
    assert nbytes == 2 * 2 * 9 * 12 * 2 + 4 * (2 * 9 * 12 + 2 * 2 * 12)


def test_wrappers_report_work_and_hide_the_plain_version():
    """Under a counter a CPU call adds its work and none of the plain
    version's ops; the same call on meta adds the same work."""
    B, S, H, Kv, D = 2, 12, 4, 2, 8
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, H, D, generator=gen)
    k = torch.randn(B, S, Kv, D, generator=gen)
    with StepCounter() as cpu:
        flash_ops.flash_attention(q, k, k, window=5)
    qm, km = q.to("meta"), k.to("meta")
    with StepCounter() as meta:
        flash_ops.flash_attention(qm, km, km, window=5)
    assert cpu.counts.aten_ops == 0 == meta.counts.aten_ops
    assert cpu.counts.kernels == meta.counts.kernels
    want = flash_ops.flash_attention_work(q, k, k, True, 5)
    assert cpu.counts.kernels["flash_attention"] == {
        "calls": 1, "flops": want[0], "bytes": want[1]}


# ---------------------------------------------------------------------------
# (b) one step counted on the CPU and on meta
# ---------------------------------------------------------------------------

def _count(arch: str, mode: str, device: str):
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("smoke", 16, 2, mode)
    impl = "xla" if mode == "train" else "decode_kernel"
    b = steps.build(cfg, shape, dtype=torch.float32, device=device,
                    attn_impl=impl)
    if device == "cpu":
        args = [b.model.init(torch.Generator().manual_seed(0))]
        args += [tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), a)
                 for a in b.abstract_args[1:]]
    else:
        args = [steps.abstract_params(b.model, torch.float32)]
        args += list(b.abstract_args[1:])
    if mode == "decode":
        # a full cache: every row attends every slot on both devices
        for c in args[2]:
            if "index" in c:
                C = (c["k"] if "k" in c else c["ckv"]).shape[1]
                c["index"] = torch.full_like(c["index"], C - 1)
    with StepCounter() as c:
        b.step_fn(*args)
    return c.counts


@pytest.mark.parametrize("arch,mode", [
    ("qwen2-moe-a2.7b", "prefill"), ("qwen2-moe-a2.7b", "decode"),
    ("qwen2-moe-a2.7b", "train"), ("xlstm-1.3b", "prefill"),
    ("xlstm-1.3b", "decode"), ("xlstm-1.3b", "train"),
    ("recurrentgemma-9b", "prefill"), ("recurrentgemma-9b", "decode"),
    ("recurrentgemma-9b", "train"), ("seamless-m4t-large-v2", "decode"),
    ("internvl2-1b", "prefill")])
def test_counts_equal_on_cpu_and_meta(arch, mode):
    cpu, meta = _count(arch, mode, "cpu"), _count(arch, mode, "meta")
    assert cpu.flops > 0 and cpu.hbm_bytes > 0
    assert cpu.flops_by_dtype == meta.flops_by_dtype
    assert cpu.hbm_bytes == meta.hbm_bytes
    assert cpu.kernels == meta.kernels
    assert cpu.peak_live_bytes == meta.peak_live_bytes
    assert cpu.aten_ops == meta.aten_ops
    if mode != "train":
        assert cpu.kernels, "the step reached no kernel"


def test_train_step_counts_its_backward():
    """The train step's count holds the backward: more than twice the
    forward's FLOPs (remat recomputes the layers)."""
    train = _count("qwen2-moe-a2.7b", "train", "meta")
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    b = steps.build(cfg, ShapeConfig("smoke", 16, 2, "prefill"),
                    dtype=torch.float32, device="meta")
    params = steps.abstract_params(b.model, torch.float32)
    with StepCounter() as fwd:
        b.model.forward(params, _meta(2, 16, dtype=torch.int64))
    assert train.flops > 2 * fwd.counts.flops


# ---------------------------------------------------------------------------
# (c) wire formulas against the reference's parse_collectives
# ---------------------------------------------------------------------------

def _reference_hlo():
    spec = importlib.util.spec_from_file_location(
        "reference_roofline_test", ROOT / "tests" / "test_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.HLO


#: each collective line of the reference test's HLO: (kind, the bytes
#: ``wire_bytes`` takes, group size)
_LINES = {
    "%ag": ("all-gather", 64 * 128 * 2, 4),
    "%ar": ("all-reduce", 32 * 32 * 4, 2),
    "%rs": ("reduce-scatter", 16 * 128 * 2, 4),
    "%a2a": ("all-to-all", 16 * 128 * 2, 4),
    "%cp": ("collective-permute", 16 * 128 * 2, 2),
    "%ars": ("all-reduce", 32 * 32 * 4, 2),
}


def test_wire_bytes_match_parse_collectives():
    for line in _reference_hlo().splitlines():
        name = line.strip().split(" ")[0]
        if name not in _LINES:
            continue
        kind, nbytes, n = _LINES[name]
        want = parse_collectives(line).wire_bytes[kind]
        assert roofline.wire_bytes(kind, nbytes, n) == pytest.approx(
            want, rel=1e-12), line
    iota = ('%ag = bf16[64,128]{1,0} all-gather(bf16[16,128]{1,0} %x), '
            'replica_groups=[16,16]<=[256], dimensions={0}')
    assert roofline.wire_bytes("all-gather", 64 * 128 * 2, 16) == \
        pytest.approx(parse_collectives(iota).wire_bytes["all-gather"])


_FAKE = r"""
import json, sys
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.roofline import StepCounter
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
g4, g2 = dist.group.WORLD, dist.new_group([0, 1])
m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")
with StepCounter() as c:
    dist.all_gather([m(16, 128) for _ in range(4)], m(16, 128), group=g4)
    dist.all_reduce(m(32, 32, dt=torch.float32), group=g2)
    dist.reduce_scatter_tensor(m(4, 128), m(16, 128), group=g4)
    dist.all_to_all_single(m(16, 128), m(16, 128), group=g4)
    dist.all_reduce(m(32, 32, dt=torch.float32), group=g2)
with StepCounter() as f:
    fc.all_reduce(m(32, 32, dt=torch.float32), "sum", g2)
    fc.all_gather_tensor(m(16, 128), 0, g4)
print(json.dumps([c.counts.as_dict(), f.counts.as_dict()]))
"""


def test_counter_collectives_match_parse_collectives():
    """The counter's c10d path (in-place and functional forms) on a fake
    group of four gives the reference's per-kind counts and wire bytes
    for the same collectives (the permute aside, which no step runs)."""
    import json
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", _FAKE], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    inplace, functional = json.loads(res.stdout.strip().splitlines()[-1])
    stats = parse_collectives(_reference_hlo())
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"):
        assert inplace["collective_counts"][kind] == stats.counts[kind]
        assert inplace["collective_bytes"][kind] == pytest.approx(
            stats.wire_bytes[kind], rel=1e-12), kind
    assert functional["collective_counts"] == {"all-reduce": 1,
                                               "all-gather": 1}
    assert functional["collective_bytes"]["all-reduce"] == pytest.approx(
        stats.wire_bytes["all-reduce"] / 2)
    assert functional["collective_bytes"]["all-gather"] == pytest.approx(
        stats.wire_bytes["all-gather"])
    # one fake host of 4 ranks: every byte is NVLink's
    assert inplace["network_bytes"] == 0.0


# ---------------------------------------------------------------------------
# (d) model_flops
# ---------------------------------------------------------------------------

def test_model_flops_match_reference_everywhere():
    assert tuple(ALL_ARCHS) == tuple(JAX_ARCHS)
    for arch in ALL_ARCHS:
        for name in SHAPES:
            got = roofline.model_flops(get_config(arch), SHAPES[name])
            want = jax_model_flops(jax_config(arch), JAX_SHAPES[name])
            assert got == want, (arch, name)


# ---------------------------------------------------------------------------
# the counter's rules
# ---------------------------------------------------------------------------

def test_counter_rules():
    x = torch.randn(64, 32, dtype=torch.bfloat16)
    w = torch.randn(32, 48, dtype=torch.bfloat16)
    with StepCounter() as c:
        v = x.reshape(32, 64).transpose(0, 1).expand(64, 32)
    assert c.counts.hbm_bytes == 0 and c.counts.flops == 0
    assert c.counts.peak_live_bytes == 0
    del v
    with StepCounter() as c:
        y = x @ w
    assert c.counts.flops_by_dtype == {"bfloat16": 2.0 * 64 * 32 * 48}
    assert c.counts.hbm_bytes == (64 * 32 + 32 * 48 + 64 * 48) * 2
    assert c.counts.peak_live_bytes == y.numel() * 2
    table = torch.randn(1000, 16)
    ids = torch.tensor([3, 7, 999])
    with StepCounter() as c:
        table[ids]
    assert c.counts.hbm_bytes == 2 * 3 * 16 * 4 + 3 * 8
    dst = torch.zeros(10, 16)
    with StepCounter() as c:
        dst.copy_(table[:10])
    assert c.counts.hbm_bytes == 2 * 10 * 16 * 4
    # log_sigmoid's buffer is device scratch (empty on CUDA, full here):
    # its forward reads x and writes y, its backward reads dy and x and
    # writes dx
    x = torch.randn(100, requires_grad=True)
    with StepCounter() as c:
        y = torch.nn.functional.logsigmoid(x)
    assert c.counts.hbm_bytes == 2 * 100 * 4
    with StepCounter(log=True) as c:
        torch.autograd.grad(y.sum(), x)
    assert ("aten.log_sigmoid_backward.default", 0, 3 * 100 * 4) in c.ops


def test_analyze_terms():
    c = roofline.Counts(flops_by_dtype={"bfloat16": 989e12,
                                        "float32": 67e12},
                        hbm_bytes=3.35e12, network_bytes=50e9,
                        nvlink_bytes=450e9, peak_live_bytes=7)
    r = roofline.analyze("x", c, 2.0, 4)
    assert r.compute_s == pytest.approx(2.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(2.0)
    assert r.dominant == "compute" and r.peak_memory_bytes == 7
    assert r.bound_s == pytest.approx(2.0)
    assert r.useful_ratio == pytest.approx(2.0 / (c.flops * 4))
