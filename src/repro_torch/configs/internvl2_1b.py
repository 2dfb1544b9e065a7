"""A copy of ``repro.configs.internvl2_1b``, kept by the port so that it
imports nothing of the JAX package; the tests hold the two against each
other.

internvl2-1b [vlm] — InternVL2 [arXiv:2404.16821].

LM backbone (Qwen2-0.5B-style): 24L, d_model=896, 14 heads (GQA kv=2),
d_ff=4864, vocab=151655. InternViT vision encoder is STUBBED per the
assignment carve-out: input_specs() provides 256 precomputed patch
embeddings per image.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    ffn_dim=4864,
    vocab_size=151655,
    attention="full",
    qkv_bias=True,
    rope_theta=1000000.0,
    frontend_tokens=256,
    source="arXiv:2404.16821",
)


def smoke():
    return CONFIG.reduced(num_heads=2, num_kv_heads=2)
