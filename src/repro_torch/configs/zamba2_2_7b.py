"""zamba2-2.7b [hybrid] — Mamba2 backbone with a SHARED attention+MLP block
applied every 6 SSM layers (one set of weights, 9 applications). Runs
long_500k (SSM state + bounded shared-attn KV).

54L d_model=2560 (d_inner=5120, 80 heads × 64, state=64); shared block:
32H kv=32, d_ff=10240, vocab=32000  [arXiv:2411.15242; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig
from repro_torch.nn.ssm import SSMArgs

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_ff=10240,
    vocab=32000,
    norm="rmsnorm",
    act="gelu",
    gated_mlp=True,
    rope_kind="rope",
    rope_theta=10_000.0,
    attn_every=6,
    ssm=SSMArgs(d_model=2560, d_inner=5120, head_dim=64, d_state=64,
                n_groups=1, conv_kernel=4, chunk=128),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="zamba2-2.7b-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=512,
    attn_every=2,
    ssm=SSMArgs(d_model=64, d_inner=128, head_dim=32, d_state=16,
                n_groups=1, conv_kernel=4, chunk=16),
    param_dtype="float32", compute_dtype="float32",
)
