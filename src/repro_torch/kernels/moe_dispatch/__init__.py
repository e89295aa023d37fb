"""Stable dispatch ranks and counts (MoE / shuffle "copy"): CUDA kernel,
wrapper, plain version, bucket scatter."""
