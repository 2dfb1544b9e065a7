"""A copy of ``repro.configs.starcoder2_3b``, kept by the port so that
it imports nothing of the JAX package; the tests hold the two against
each other.

starcoder2-3b [dense] — StarCoder 2 and The Stack v2 [arXiv:2402.19173].

30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288, vocab=49152. GQA, RoPE.
(StarCoder2-3B uses sliding-window 4096 attention; we model it with the
sliding variant, which also makes long_500k decode natively feasible.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    ffn_dim=12288,
    vocab_size=49152,
    attention="sliding",
    sliding_window=4096,
    qkv_bias=True,
    rope_theta=100000.0,
    source="arXiv:2402.19173",
)


def smoke():
    return CONFIG.reduced()
