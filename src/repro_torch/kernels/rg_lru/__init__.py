"""rg_lru kernel: plain version (ref), CUDA launch (kernel), wrapper (ops)."""
