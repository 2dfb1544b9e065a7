"""A copy of ``repro.configs.llama3_405b``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against each
other.

llama3-405b [dense] — The Llama 3 Herd of Models [arXiv:2407.21783].

126L, d_model=16384, 128 heads (GQA kv=8), d_ff=53248, vocab=128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    ffn_dim=53248,
    vocab_size=128256,
    attention="full",
    rope_theta=500000.0,
    source="arXiv:2407.21783",
)


def smoke():
    return CONFIG.reduced()
