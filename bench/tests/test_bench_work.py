"""The benchmark's operation and byte counts against counts worked by
hand at small shapes, and the import hygiene of everything the benchmark
runs: no module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``repro`` (compared whole: ``repro_torch`` is the program)."""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from bench.work import counts, peaks

ROOT = Path(__file__).resolve().parents[2]

MLA = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 2,
       "head_dim": 4, "vocab_size": 10, "attention": "mla",
       "mla_kv_lora_rank": 3,
       "moe": {"num_experts": 4, "top_k": 2, "expert_ffn_dim": 5,
               "num_shared_experts": 1, "shared_ffn_dim": 6}}
GQA = {"num_layers": 3, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
       "head_dim": 2, "vocab_size": 10, "attention": "full",
       "moe": {"num_experts": 4, "top_k": 1, "expert_ffn_dim": 5,
               "num_shared_experts": 0, "shared_ffn_dim": 0}}


def test_causal_pairs():
    assert [counts.causal_pairs(n) for n in (1, 2, 3, 10)] == [1, 3, 6, 55]


def test_flash_work_by_hand():
    # MLA: 2 heads of 4, the kernel's key heads = query heads; 3 positions
    # attend 6 pairs: 4 * 2 * 4 * 6 FLOPs; q, out, k, v: 4 * 3 * 2 * 4
    # values of 2 bytes
    assert counts.flash_work(MLA, [3]) == (192, 192)
    # GQA: 4 heads of 2 over 2 KV heads; lengths 1 and 2 attend 1 + 3
    # pairs: 4 * 4 * 2 * 4 FLOPs; (2*n*4*2 + 2*n*2*2) * 2 bytes
    assert counts.flash_work(GQA, [1, 2]) == (128, (24 + 48) * 2)


def test_decode_attention_work_by_hand():
    # one query over 5 positions: 4 * 4 * 2 * 5 FLOPs; K and V rows 2 * 5
    # * 2 * 2 values, q and out 2 * 4 * 2, of 2 bytes, + the length (4)
    assert counts.decode_attention_work(GQA, [5]) == (160, (40 + 16) * 2 + 4)
    f, b = counts.decode_attention_work(GQA, [5, 0])
    assert f == 160 and b == (40 + 16) * 2 + 4 + 16 * 2 + 4


def test_token_flops_by_hand():
    # MLA layer: wq 8*8, w_dkv 8*3, w_ukv 3*16, w_kpe 8*4, wo 8*8 = 232;
    # router 8*4 = 32; 2 routed experts 2*3*8*5 = 240; shared 3*8*6 = 144
    assert counts.token_linear_flops(MLA) == 2 * 2 * (232 + 32 + 240 + 144)
    # GQA layer: wq 8*8, wk and wv 2 * 8*4, wo 8*8 = 192; router 32;
    # one routed expert 120
    assert counts.token_linear_flops(GQA) == 2 * 3 * (192 + 32 + 120)
    assert counts.readout_flops(GQA) == 160


def test_prefill_and_decode_flops_compose():
    n = 7
    assert counts.prefill_flops(GQA, n) == (
        n * counts.token_linear_flops(GQA)
        + 3 * counts.attention_core_flops(GQA, 28))
    assert counts.decode_flops(MLA, 9) == (
        counts.token_linear_flops(MLA) + 2 * 4 * 2 * 4 * 9
        + counts.readout_flops(MLA))


def test_peaks_are_the_h100_sxm_data_sheet():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("config", ["deepseek-v2-lite", "qwen3-235b-a22b.l8"])
def test_the_configs_parameter_count(config):
    from bench import model as bm
    served = json.loads((ROOT / "bench" / "configs" / f"{config}.json")
                        .read_text())["served"]
    want = {"deepseek-v2-lite": 16.16e9, "qwen3-235b-a22b.l8": 21.15e9}
    n = sum(math.prod(shape) for _, shape, _, _ in bm.param_specs(served))
    assert abs(n - want[config]) < 0.01e9


def test_the_benchmark_imports_neither_jax_nor_the_reference_package():
    code = """
import sys, importlib, pathlib
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
import bench.harness, bench.check, bench.trace, bench.model, bench.traffic
import bench.reference.mla_moe, bench.reference.gqa_moe
from bench import harness
for path in sorted((root / "bench" / "metrics").glob("*.py")):
    if not path.name.startswith("_"):
        harness.reader(path.stem)
import repro_torch.runtime.engine, repro_torch.core.dep
import repro_torch.sched.policy, repro_torch.core.planner
print(",".join(harness.forbidden_modules()))
print(",".join(sorted({m.split('.')[0] for m in sys.modules})))
"""
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin"}).stdout.splitlines()
    assert out[0] == ""
    tops = set(out[1].split(","))
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_names_are_compared_whole():
    from bench import harness
    assert harness.forbidden(["repro_torch", "repro_torch.models",
                              "reprox", "jaxtyping", "bench"]) == []
    assert harness.forbidden(["repro.models.moe", "jax", "jaxlib.xla",
                              "flax", "repro_torch"]) == [
        "flax", "jax", "jaxlib", "repro"]
