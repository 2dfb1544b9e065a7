"""A copy of ``repro.configs.command_r_35b``, kept by the port so that
it imports nothing of the JAX package; the tests hold the two against
each other.

command-r-35b [dense] — [hf:CohereForAI/c4ai-command-r-v01].

40L, d_model=8192, 64 heads (GQA kv=8), d_ff=22528, vocab=256000.
GQA, no bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    ffn_dim=22528,
    vocab_size=256000,
    attention="full",
    qkv_bias=False,
    rope_theta=8000000.0,
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)


def smoke():
    return CONFIG.reduced()
