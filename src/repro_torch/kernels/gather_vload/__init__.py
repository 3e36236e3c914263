"""Standalone gather replacement: CUDA kernel, wrapper and plain version."""
