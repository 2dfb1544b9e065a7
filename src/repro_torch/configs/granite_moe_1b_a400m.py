"""A copy of ``repro.configs.granite_moe_1b_a400m``, kept by the port so
that it imports nothing of the JAX package; the tests hold the two
against each other.

granite-moe-1b-a400m [moe] — [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model=1024, 16 heads (GQA kv=8), expert d_ff=512, vocab=49155,
MoE: 32 routed experts top-8, no shared experts (the paper's Qwen3-MoE-like
"no shared" scheduling case).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    ffn_dim=0,
    vocab_size=49155,
    attention="full",
    tie_embeddings=True,
    moe=MoEConfig(
        num_experts=32,
        top_k=8,
        expert_ffn_dim=512,
        num_shared_experts=0,
    ),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke():
    return CONFIG.reduced()
