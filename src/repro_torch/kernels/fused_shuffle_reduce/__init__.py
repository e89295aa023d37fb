"""Fused gather + sorted segment-sum: CUDA kernel, wrapper, plain version."""
