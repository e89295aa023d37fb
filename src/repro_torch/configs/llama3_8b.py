"""llama3-8b [dense] — GQA kv=8, 128k vocab.

32L d_model=4096 32H (kv=8) d_ff=14336 vocab=128256  [arXiv:2407.21783]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=128256,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_kind="rope",
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="llama3-8b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=512,
    param_dtype="float32", compute_dtype="float32",
)
