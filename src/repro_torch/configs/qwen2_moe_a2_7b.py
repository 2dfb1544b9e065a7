"""qwen2-moe-a2.7b [moe] — [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model=2048, 16 heads (kv=16), expert d_ff=1408, vocab=151936,
MoE: 60 routed experts top-4 + 4 shared experts.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    ffn_dim=0,
    vocab_size=151936,
    attention="full",
    qkv_bias=True,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        expert_ffn_dim=1408,
        num_shared_experts=4,
        shared_ffn_dim=1408,
    ),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def smoke():
    return CONFIG.reduced()
