"""starcoder2-3b [dense] — GQA kv=2, RoPE, layernorm+bias, non-gated GELU MLP.

30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152  [arXiv:2402.19173; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv=2,
    d_ff=12288,
    vocab=49152,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    rope_kind="rope",
    rope_theta=999999.4,  # published rope_theta
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="starcoder2-3b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=512,
    param_dtype="float32", compute_dtype="float32",
)
