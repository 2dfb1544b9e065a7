"""A copy of ``repro.configs.deepseek_v2_lite``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

deepseek-v2-lite — DeepSeek-V2 [arXiv:2405.04434]; the paper's primary
MoE backbone (shared experts + MLA). Used by the benchmark tables, not part
of the assigned-10 grid.

27L, d_model=2048, 16 heads, MLA kv_lora_rank=512, 64 routed experts top-6,
2 shared experts, expert d_ff=1408, vocab=102400. First layer dense
(d_ff=10944) in the real model; we make every layer MoE for scheduling
fidelity to the paper's DEP experiments (they use small layer-count
variants of DeepSeek-V2 236B).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    ffn_dim=0,
    vocab_size=102400,
    attention="mla",
    mla_kv_lora_rank=512,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        expert_ffn_dim=1408,
        num_shared_experts=2,
        shared_ffn_dim=1408,
    ),
    source="arXiv:2405.04434",
)


def smoke():
    return CONFIG.reduced()
