"""qwen2-1.5b [dense] — Qwen2 Technical Report [arXiv:2407.10671].

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
GQA with QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    ffn_dim=8960,
    vocab_size=151936,
    attention="full",
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671",
)


def smoke():
    return CONFIG.reduced()
