"""moe_gemm kernel: plain version (ref), CUDA launch (kernel), wrapper (ops)."""
