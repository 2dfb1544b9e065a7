"""FLOPs and bytes of the served models' work, from the configuration's
``served`` section (a dict) and the token counts alone.

A multiply-add is two FLOPs. ``bytes_per`` is the served dtype's size.
"""
from __future__ import annotations

from typing import Dict, Iterable


def causal_pairs(n: int) -> int:
    """(query, key) pairs of causal attention over n positions."""
    return n * (n + 1) // 2


def attention_core_flops(served: Dict, pairs: int) -> int:
    """Scores and the weighted sum (q·k and p·v) over ``pairs``
    attended (query, key) pairs, at every query head."""
    return 4 * served["num_heads"] * served["head_dim"] * pairs


def flash_work(served: Dict, lengths: Iterable[int], bytes_per: int = 2):
    """(FLOPs, bytes) of causal prefill attention over prompts of
    ``lengths`` positions: q and the output at every head, k and v at
    the kernel's key heads (MLA runs it with a key head per query head),
    each read or written once."""
    H, D = served["num_heads"], served["head_dim"]
    kv = H if served["attention"] == "mla" else served["num_kv_heads"]
    flops = nbytes = 0
    for n in lengths:
        flops += attention_core_flops(served, causal_pairs(n))
        nbytes += (2 * n * H * D + 2 * n * kv * D) * bytes_per
    return flops, nbytes


def decode_attention_work(served: Dict, lengths: Iterable[int],
                          bytes_per: int = 2):
    """(FLOPs, bytes) of one decode query per row over ``lengths``
    cached positions (the new one among them): each position's K and V
    row read once, q read and the output written once a row."""
    H, Kv, D = (served["num_heads"], served["num_kv_heads"],
                served["head_dim"])
    flops = nbytes = 0
    for n in lengths:
        flops += attention_core_flops(served, n)
        nbytes += (2 * n * Kv * D + 2 * H * D) * bytes_per + 4
    return flops, nbytes


def token_linear_flops(served: Dict) -> int:
    """FLOPs of one token through every layer's projections, router,
    top-k routed experts and shared experts (no attention core, no
    readout)."""
    M, H, Kv, D = (served["d_model"], served["num_heads"],
                   served["num_kv_heads"], served["head_dim"])
    m = served["moe"]
    if served["attention"] == "mla":
        r = served["mla_kv_lora_rank"]
        attn = M * H * D + M * r + r * 2 * H * D + M * D + H * D * M
    else:
        attn = M * H * D + 2 * M * Kv * D + H * D * M
    routed = m["top_k"] * 3 * M * m["expert_ffn_dim"]
    shared = 3 * M * m["num_shared_experts"] * m["shared_ffn_dim"]
    router = M * m["num_experts"]
    return 2 * served["num_layers"] * (attn + router + routed + shared)


def readout_flops(served: Dict) -> int:
    return 2 * served["d_model"] * served["vocab_size"]


def prefill_flops(served: Dict, n: int) -> int:
    """A prompt's n prefilled positions through every layer with causal
    attention; no readout (a served token's logits come from a decode
    step)."""
    return (n * token_linear_flops(served)
            + served["num_layers"] * attention_core_flops(
                served, causal_pairs(n)))


def decode_flops(served: Dict, context: int) -> int:
    """One generated token whose query attends ``context`` positions:
    its layers, its attention and its readout."""
    return (token_linear_flops(served)
            + served["num_layers"] * attention_core_flops(served, context)
            + readout_flops(served))
