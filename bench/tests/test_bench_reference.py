"""The plain float32 references against the served model (``repro_torch``'s
``Model`` on the same weights, float32 on the CPU): the full forward, and
prefill followed by decode through the cache, at smoke widths of both
configurations."""
import pytest
import torch

from bench import model as bm
from bench.check import _reference_layer
from bench.reference import common
from bench.tests import smoke

CONFIGS = ("deepseek-v2-lite", "qwen3-235b-a22b.l8")


def _program(served):
    from repro_torch.models import build_model
    from repro_torch.models.transformer import ExecutionContext
    return build_model(bm.model_config(served),
                       ctx=ExecutionContext(moe_impl="capacity"),
                       dtype=torch.float32, device="cpu")


def _reference(served, params, seqs, start):
    return common.forward(params, bm.reference_config(served),
                          _reference_layer(served), seqs, start)


@pytest.mark.parametrize("config", CONFIGS)
def test_forward_matches_the_served_model(config):
    served = smoke.served(config)
    params = bm.draw_params(served, 11, torch.device("cpu"))
    tokens = torch.randint(0, served["vocab_size"], (2, 24),
                           generator=torch.Generator().manual_seed(1))
    logits, _ = _program(served).forward(params, tokens)
    ref = _reference(served, params, list(tokens), [0, 0])
    for row in range(2):
        torch.testing.assert_close(logits[row], ref[row], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("config", CONFIGS)
def test_prefill_then_decode_matches_the_full_forward(config):
    served = smoke.served(config)
    params = bm.draw_params(served, 12, torch.device("cpu"))
    model = _program(served)
    seq = torch.randint(0, served["vocab_size"], (30,),
                        generator=torch.Generator().manual_seed(2))
    P = 17
    logits, caches = model.prefill(params, seq[None, :P], seq_budget=32)
    got = [logits[0, 0]]
    for t in range(P, seq.numel() - 1):
        logits, caches = model.decode_step(params, seq[None, t:t + 1],
                                           caches)
        got.append(logits[0, 0])
    ref = _reference(served, params, [seq[:-1]], [P - 1])[0]
    torch.testing.assert_close(torch.stack(got), ref, rtol=1e-4, atol=1e-4)


def test_reference_sets_float32_products():
    torch.backends.cuda.matmul.allow_tf32 = True
    common.strict_float32()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(3))
    e8 = (common.fp8_round(x) - x).abs().mean()
    e16 = (x.to(torch.bfloat16).float() - x).abs().mean()
    assert e8 > 4 * e16 > 0


def test_moe_drops_no_token_and_renormalises():
    served = smoke.served("qwen3-235b-a22b.l8")
    cfg = bm.reference_config(served)
    params = bm.draw_params(served, 13, torch.device("cpu"))
    p = common.to_f32(params["layers"][0]["moe"])
    x = torch.randn(5, served["d_model"],
                    generator=torch.Generator().manual_seed(4))
    y = common.moe(p, x, cfg, common.matmul)
    # the same layer written token by token
    for t in range(5):
        probs = torch.softmax(x[t] @ p["router"]["kernel"], -1)
        w, idx = torch.topk(probs, cfg["moe"]["top_k"])
        w = w / w.sum()
        ex = p["experts"]
        want = sum(wi * common.swiglu(x[t], ex["gate"][e], ex["up"][e],
                                      ex["down"][e], common.matmul)
                   for wi, e in zip(w, idx.tolist()))
        torch.testing.assert_close(y[t], want, rtol=1e-5, atol=1e-6)
