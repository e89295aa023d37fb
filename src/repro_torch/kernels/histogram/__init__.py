"""Per-slot weighted histogram: CUDA kernel, wrapper, plain version."""
