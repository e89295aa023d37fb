"""Sorted segment-sum of every slot: CUDA kernel, wrapper, plain version."""
