"""A copy of ``repro.configs.qwen3_moe``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against
each other.

qwen3-moe — Qwen3 Technical Report [arXiv:2505.09388]; the paper's
no-shared-experts MoE backbone (benchmark tables). Qwen3-235B-A22B scaled
hyperparameters: 94L in full; the paper uses reduced-layer variants.

d_model=4096, 64 heads (GQA kv=4), 128 routed experts top-8, expert
d_ff=1536, vocab=151936, NO shared experts.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe",
    family="moe",
    num_layers=48,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    ffn_dim=0,
    vocab_size=151936,
    attention="full",
    moe=MoEConfig(
        num_experts=128,
        top_k=8,
        expert_ffn_dim=1536,
        num_shared_experts=0,
    ),
    source="arXiv:2505.09388",
)


def smoke():
    return CONFIG.reduced()
