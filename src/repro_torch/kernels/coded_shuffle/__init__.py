"""Coded-shuffle XOR of word slabs: CUDA kernel, wrapper, plain version."""
