"""A copy of ``repro.configs.seamless_m4t_large_v2``, kept by the port
so that it imports nothing of the JAX package; the tests hold the two
against each other.

seamless-m4t-large-v2 [audio] — SeamlessM4T [arXiv:2308.11596].

Encoder-decoder transformer backbone: 24 decoder layers (+24 encoder
layers), d_model=1024, 16 heads (kv=16), d_ff=8192, vocab=256206.
The speech frontend (mel-spectrogram + conformer feature extractor) is
STUBBED per the assignment carve-out: input_specs() provides precomputed
frame embeddings. The decoder uses sliding-window attention for the
long_500k decode shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    ffn_dim=8192,
    vocab_size=256206,
    attention="full",
    is_encoder_decoder=True,
    num_encoder_layers=24,
    frontend_tokens=1024,
    source="arXiv:2308.11596",
)


def smoke():
    return CONFIG.reduced(frontend_tokens=8)
