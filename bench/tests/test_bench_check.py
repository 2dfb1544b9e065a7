"""The check's pieces: which requests it compares, the gaps it reads,
and the control's arithmetic (the fp8 control at smoke widths on the
CPU, against a bf16 run of the program on the same prompts)."""
import time
from types import SimpleNamespace

import pytest
import torch

from bench import check, harness
from bench.tests import smoke


@pytest.fixture(autouse=True)
def one_thread():
    """The engine runs at smoke widths: one intra-op thread each, so that
    the test workers sharing the host do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rec(index, n_out, finish_t, greedy=True, finished=True):
    return SimpleNamespace(
        spec=SimpleNamespace(index=index, greedy=greedy, prompt=[1, 2]),
        finished=finished,
        req=SimpleNamespace(output=[3] * n_out, finish_t=finish_t))


def test_sample_takes_the_longest_then_a_seeded_order():
    recs = [_rec(0, 5, 1.0), _rec(2, 40, 2.0), _rec(4, 7, 3.0),
            _rec(6, 9, 4.0), _rec(8, 50, 9.0),            # after the window
            _rec(1, 60, 2.0, greedy=False),               # sampled at T > 0
            _rec(10, 70, 2.0, finished=False)]            # cut short
    a = check.sample(recs, 0.5, 5.0, seed=7, served_tokens=50)
    assert a[0].spec.index == 2
    assert {r.spec.index for r in a} <= {0, 2, 4, 6}
    assert sum(len(r.req.output) for r in a) >= 50 or len(a) == 4
    assert [r.spec.index for r in a] == [
        r.spec.index for r in check.sample(recs, 0.5, 5.0, 7, 50)]
    assert check.sample(recs, 10.0, 11.0, 7, 50) == []


def test_gaps_read_the_reference_at_the_picked_tokens():
    ref = [torch.tensor([[0.0, 2.0, 1.0], [3.0, 1.0, 0.5]])]
    g = check.gaps(ref, [torch.tensor([1, 2])])
    assert g.tolist() == [0.0, 2.5]
    assert check.reading(g) == {"mean": 1.25, "widest": 2.5}


@pytest.mark.parametrize("cell,config", [
    ("dsv2lite.chat", "deepseek-v2-lite"),
    ("qwen3moe.chat", "qwen3-235b-a22b.l8")])
def test_the_fp8_control_reads_far_above_the_served_precision(cell, config):
    """At smoke widths the served bf16 tokens read a mean gap well under
    the fp8 control's on the same prompts and tokens (on the card, at the
    cells' sizes, the readings are in PERF.md)."""
    served = smoke.served(config, dtype="bfloat16", d_model=256,
                          vocab_size=2048)
    served["moe"].update(expert_ffn_dim=128)
    run, rd = harness.run_cell(cell, 3, 0, False, time.perf_counter(),
                               device="cpu", served=served,
                               mix=smoke.mix(check={"served_tokens": 200}),
                               control=True, window_steps=80)
    assert run.checked_tokens > 50
    assert rd["control"]["mean"] > 3 * rd["program"]["mean"]


@pytest.mark.parametrize("cell,config", [
    ("dsv2lite.chat", "deepseek-v2-lite"),
    ("qwen3moe.chat", "qwen3-235b-a22b.l8")])
def test_the_readings_tool_puts_the_control_through_the_verdict(cell,
                                                                config):
    """``tools/readings.py``'s line at smoke widths, with a limit set as
    the cells' are (between the program's reading and the control's):
    the program comes out correct and the control not."""
    from bench.tools import readings
    served = smoke.served(config, dtype="bfloat16", d_model=256,
                          vocab_size=2048)
    served["moe"].update(expert_ffn_dim=128)
    kw = dict(device="cpu", served=served,
              mix=smoke.mix(check={"served_tokens": 200}), window_steps=80)
    first = readings.reading_line(cell, 3, 0, None, **kw)
    assert first["program_correct"] is False      # no limit, no verdict
    limit = (first["program"]["mean"] * first["control"]["mean"]) ** 0.5
    line = readings.reading_line(cell, 3, 0, limit, **kw)
    assert line["program"] == first["program"]
    assert line["program_correct"] is True
    assert line["control_correct"] is False
