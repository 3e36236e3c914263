"""Standalone segmented reduction: CUDA kernel, wrapper and plain version."""
