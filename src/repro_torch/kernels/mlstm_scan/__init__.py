"""mlstm_scan kernel: plain version (ref), CUDA launch (kernel), wrapper (ops)."""
