"""The metric readers' arithmetic on synthetic windows: rates over the
whole window, tails over every request and every gap, a stall that moves
``itl_p95_ms`` and the rates, and the per-layer readers on the engine's
counter deltas and a synthetic trace."""
from types import SimpleNamespace

import pytest

from bench import harness
from bench.trace import Event, Trace
from bench.work import counts, peaks

SERVED = {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
          "head_dim": 2, "vocab_size": 10, "attention": "full",
          "moe": {"num_experts": 4, "top_k": 1, "expert_ffn_dim": 5,
                  "num_shared_experts": 0, "shared_ffn_dim": 0}}


def window(step_s, n_clients=4, prompt=10, stall=()):
    """Steps of ``step_s`` seconds (``stall``: indices of steps that take
    ten times longer); every client's request gets a token each step; a
    request is admitted (its prompt prefilled) and sent at the window's
    start, and its first token comes one step later."""
    t, steps = 0.0, []
    recs = {}
    for c in range(n_clients):
        req = SimpleNamespace(arrival_t=0.0, first_token_t=None, output=[],
                              state=SimpleNamespace(value="running"))
        recs[c] = SimpleNamespace(spec=SimpleNamespace(prompt=[1] * prompt,
                                                       index=c),
                                  req=req, token_times=[], sent=0.0)
    for i in range(100):
        t0 = t
        t += step_s * (10 if i in stall else 1)
        tokens = []
        for r in recs.values():
            r.req.output.append(3)
            r.token_times.append(t)
            if r.req.first_token_t is None:
                r.req.first_token_t = t
            tokens.append((r.spec.index, prompt + len(r.req.output) - 1))
        steps.append(harness.StepRec(t0, t, tokens,
                                     list(recs) if i == 0 else []))
    zero = dict(prefill_s=0.0, decode_s=0.0, steps=0, prefill_tokens=0,
                plan_misses=0, graph_captures=0)
    after = dict(prefill_s=0.2 * t, decode_s=0.6 * t, steps=100,
                 prefill_tokens=n_clients * (prompt - 1), plan_misses=3,
                 graph_captures=1)
    return harness.Window({"name": "x.chat", "traffic": "chat"}, SERVED,
                          {"clients": n_clients, "slots": n_clients}, 12.5,
                          0.0, t, steps, recs, zero, after, [])


def read(name, w):
    return harness.reader(name)(w)


def test_rates_are_all_the_work_over_the_whole_window():
    w = window(0.05)
    assert w.seconds == pytest.approx(5.0)
    assert read("output_tok_s", w) == pytest.approx(400 / 5.0)
    assert read("prompt_tok_s", w) == pytest.approx(40 / 5.0)
    assert read("setup_s", w) == 12.5


def test_tails_are_over_every_request_and_every_gap():
    w = window(0.05)
    assert read("itl_p95_ms", w) == pytest.approx(50.0)
    assert read("ttft_p90_ms", w) == pytest.approx(50.0)


def test_a_stall_moves_the_gap_tail_and_the_rates():
    calm, stalled = window(0.05), window(0.05, stall=range(40, 48))
    assert read("itl_p95_ms", stalled) == pytest.approx(500.0)
    assert read("itl_p95_ms", calm) == pytest.approx(50.0)
    assert read("output_tok_s", stalled) < 0.6 * read("output_tok_s", calm)
    assert read("prompt_tok_s", stalled) < 0.6 * read("prompt_tok_s", calm)
    # the median gap does not see it: the tail does
    assert read("ttft_p90_ms", stalled) == read("ttft_p90_ms", calm)


def test_ttft_counts_only_first_tokens_inside_the_window():
    w = window(0.05)
    w.recs[0].req.first_token_t = -1.0        # before the window
    w.recs[1].req.first_token_t = None        # never came
    w.recs[2].req.arrival_t = -0.95           # waited a second
    assert read("ttft_p90_ms", w) == pytest.approx(
        50 + 0.9 * 950, rel=1e-9)


def test_engine_counter_readers():
    w = window(0.05)
    assert read("engine_host_pct.chat", w) == pytest.approx(20.0)
    assert read("plan_misses.chat", w) == 3.0
    assert read("graph_captures.longprompt", w) == 1.0
    assert read("decode_step_ms.chat", w) == pytest.approx(30.0)
    assert read("prefill_ms_per_ktok.chat", w) == pytest.approx(
        1e3 * 1.0 / (36 / 1e3))


def test_dep_gemm_launches_per_call():
    w = window(0.05)
    g = lambda r1, r2: SimpleNamespace(graph=SimpleNamespace(r1=r1, r2=r2))
    w.programs = [("decode", g(1, 1)), ("decode", g(2, 2)),
                  ("prefill", g(1, 4))]
    assert read("dep_gemm_launches.chat", w) == pytest.approx(2 * 2.5)
    assert read("dep_gemm_launches.longprompt", w) == pytest.approx(8)
    w.programs = []
    assert read("dep_gemm_launches.chat", w) is None


def test_mfu_prices_the_window_tokens():
    w = window(0.05)
    want = 4 * counts.prefill_flops(SERVED, 9) + sum(
        counts.decode_flops(SERVED, n) for s in w.steps for _, n in s.tokens)
    assert read("mfu_pct.chat", w) == pytest.approx(
        100 * want / (w.seconds * peaks.BF16_FLOPS))


def _trace(w, flash_ns, decode_ns, launches):
    dev = [Event("flash_attention_wgmma_kernel<bf16>", 1000, 1000 + flash_ns),
           Event("decode_attention_split_kernel", 2_000_000,
                 2_000_000 + decode_ns),
           Event("decode_attention_combine_kernel", 3_000_000, 3_000_100)]
    t = Trace(dev, [Event("aten::mm", 0, 10_000_000)], 0, 10_000_000,
              w.steps[:2], launches)
    t.complete = {"flash_attention_": True, "decode_attention_": True}
    return t


def test_trace_readers():
    w = window(0.05)
    w.trace = _trace(w, 50_000, 40_000, {"flash_attention": 1,
                                         "decode_attention": 1})
    busy = 50_000 + 40_000 + 100
    assert w.trace.busy_s == pytest.approx(busy * 1e-9)
    assert read("device_idle_pct.chat", w) == pytest.approx(
        100 * (1 - busy / 10_000_000))
    f, b = counts.flash_work(SERVED, [9] * 4)
    want = 2 * max(f / peaks.BF16_FLOPS, b / peaks.HBM_BYTES_PER_S)
    assert read("flash_roofline.longprompt", w) == pytest.approx(
        100 * want / 50e-6)
    lens = [n for s in w.steps[:2] for _, n in s.tokens]
    f, b = counts.decode_attention_work(SERVED, lens)
    want = 2 * max(f / peaks.BF16_FLOPS, b / peaks.HBM_BYTES_PER_S)
    assert read("decode_attn_roofline.chat", w) == pytest.approx(
        100 * want / 40.1e-6)
    gaps = dict(w.trace.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(w.trace.window_s
                                               - w.trace.busy_s)
    assert set(gaps) == {"aten::mm", "gaps under 10 us"}


def test_a_short_trace_reads_nothing():
    w = window(0.05)
    w.trace = _trace(w, 50_000, 40_000, {})
    w.trace.complete["flash_attention_"] = False
    assert read("flash_roofline.longprompt", w) is None
    # a trace that lost events of a counted kernel reads no idle share
    assert read("device_idle_pct.chat", w) is None
    w.trace = None
    assert read("device_idle_pct.chat", w) is None
    assert read("decode_attn_roofline.chat", w) is None
