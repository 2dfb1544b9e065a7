"""decode_attention kernel: plain version (ref), CUDA launch (kernel), wrapper (ops)."""
