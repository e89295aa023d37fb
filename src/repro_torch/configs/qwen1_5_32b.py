"""qwen1.5-32b [dense] — MHA (kv=40), QKV bias, gated SiLU.

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064  [hf:Qwen/Qwen1.5; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_kind="rope",
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen1.5-32b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=160, vocab=512,
    param_dtype="float32", compute_dtype="float32",
)
