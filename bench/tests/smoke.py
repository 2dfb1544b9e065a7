"""Small sizes of the benchmark's configurations and mixes for the CPU
tests: the served sections' structure with tiny widths, and a mix of a
few clients and short requests."""
from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def served(config: str, dtype: str = "float32", **over):
    """A configuration's served section at smoke widths: 2 layers,
    d_model 64, 4 heads of 16 (MLA) or 8 over 2 KV heads of 32 (GQA), 8
    experts top-2 of 32, vocab 256, still dropless (capacity E / k)."""
    s = copy.deepcopy(json.loads(
        (BENCH / "configs" / f"{config}.json").read_text())["served"])
    s.update(num_layers=2, d_model=64, vocab_size=256)
    if s["attention"] == "mla":
        s.update(num_heads=4, num_kv_heads=4, head_dim=16,
                 mla_kv_lora_rank=32)
    else:
        s.update(num_heads=8, num_kv_heads=2, head_dim=32)
    m = s["moe"]
    m.update(num_experts=8, top_k=2, expert_ffn_dim=32,
             shared_ffn_dim=32 if m["num_shared_experts"] else 0,
             capacity_factor=4.0)
    s.update(dtype=dtype, profile="paper_a6000")
    s.update(over)
    return s


def mix(name: str = "chat", **over):
    """A mix file's structure with 4 clients and short requests."""
    m = json.loads((BENCH / "mixes" / f"{name}.json").read_text())
    m.update(clients=4, slots=4, max_context=128, token_budget=256,
             prompt={"law": "log_uniform", "lo": 8, "hi": 60},
             output={"law": "log_uniform", "lo": 4, "hi": 20}, pool=16,
             warmup={"min_steps": 4, "quiet_steps": 4, "max_steps": 12},
             check={"served_tokens": 30})
    m.update(over)
    return m
