"""Count-min sketch grid of every slot: CUDA kernel, wrapper, plain version."""
