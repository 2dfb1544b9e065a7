"""A run with the timed path broken underneath must come out not
correct. The harness runs a cell at smoke widths on the CPU (float32,
where a sound run's served tokens are the reference's best: gap 0),
skipping only its look for a chip, once sound and once with each fault
a serving cell can have planted in the program:

- a decode step that returns its state unchanged (the caches' indices
  are not committed);
- half of the batch left out: the second half of the slots decode with
  the first half's logits;
- the exchange between chips left out: the DEP walk's all_to_all does
  nothing, so the experts read and return unwritten buffers;
- a token altered where it is produced: the sampler's pick moved by one.
"""
import time

import pytest
import torch

from bench import check, harness
from bench.tests import smoke

#: a float32 run at these widths serves the reference's own argmax; any
#: gap over this is a fault
SMOKE_LIMIT = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """The engine runs at smoke widths: one intra-op thread each, so that
    the test workers sharing the host do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell="dsv2lite.chat", config="deepseek-v2-lite", mix="chat",
         seed=5):
    # every greedy request finished in the window is compared, so the
    # faults that touch some slots only are seen
    run, _ = harness.run_cell(cell, seed, 0, False, time.perf_counter(),
                              device="cpu", served=smoke.served(config),
                              mix=smoke.mix(mix, check={"served_tokens":
                                                        10_000}),
                              window_steps=60)
    return run


def _verdict(run):
    return check.verdict(run.gap["mean"], SMOKE_LIMIT, run.checked_tokens)


@pytest.mark.parametrize("cell,config,mix", [
    ("dsv2lite.chat", "deepseek-v2-lite", "chat"),
    ("qwen3moe.chat", "qwen3-235b-a22b.l8", "longprompt")])
def test_a_sound_run_is_correct(cell, config, mix):
    run = _run(cell, config, mix)
    assert run.checked_tokens >= 30 and run.checked_requests >= 2
    assert run.gap["widest"] == pytest.approx(0.0, abs=1e-6)
    assert _verdict(run)
    attempted, failed = harness.counts(run.window)
    assert attempted > 0 and failed == 0


def test_every_served_token_comes_from_a_decode_step():
    """The engine prefills a prompt but its last token, and the decode
    step that feeds that token serves the first output: every token the
    window counts went through a decode step (what the decode roofline
    and ``output_tok_s`` count), and the prefill covered the rest."""
    w = _run().window
    assert sum(len(s.tokens) for s in w.steps) == w.delta("decode_tokens")
    assert w.delta("prefill_tokens") == sum(
        len(w.recs[k].spec.prompt) - 1 for s in w.steps for k in s.admitted)


def _state_unchanged(monkeypatch):
    from repro_torch.runtime import decode_graph
    monkeypatch.setattr(decode_graph, "commit_states",
                        lambda caches, new: None)


def _half_batch(monkeypatch):
    from repro_torch.models.transformer import Model
    real = Model.decode_step

    def half(self, *a, **k):
        logits, *rest = real(self, *a, **k)
        n = logits.shape[0] // 2
        logits = torch.cat([logits[:n], logits[:logits.shape[0] - n]])
        return (logits, *rest)
    monkeypatch.setattr(Model, "decode_step", half)


def _no_exchange(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "all_to_all_single",
                        lambda recv, send, group=None: recv.fill_(0))


def _altered_token(monkeypatch):
    from repro_torch.runtime import decode_graph
    real = decode_graph.sample

    def moved(gen, logits, *a, **k):
        return (real(gen, logits, *a, **k) + 1) % logits.shape[-1]
    monkeypatch.setattr(decode_graph, "sample", moved)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _no_exchange, _altered_token],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_comes_out_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    run = _run()
    assert run.checked_tokens > 0
    assert run.gap["mean"] > 100 * SMOKE_LIMIT
    assert not _verdict(run)


def test_no_tokens_compared_is_not_correct():
    assert not check.verdict(0.0, SMOKE_LIMIT, 0)
    assert not check.verdict(None, SMOKE_LIMIT, 10)
    assert not check.verdict(0.0, None, 10)
