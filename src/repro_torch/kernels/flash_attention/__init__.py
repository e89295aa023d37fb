"""Causal GQA flash attention (prefill) and the decode path: CUDA kernel,
wrapper, plain version."""
