"""MoE token-dispatch row gather: CUDA kernel, wrapper and plain version."""
