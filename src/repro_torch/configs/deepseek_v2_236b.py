"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 160 routed experts top-6
with 2 shared experts; first layer dense. The PRIMARY OS4M application:
160 experts over a 16-way model axis = 10 operation clusters per slot,
a real P||C_max instance solved by the BSS balancer every rebalance
interval (repro.core.balancer).

60L d_model=5120 128H d_ff=1536/expert vocab=102400  [arXiv:2405.04434; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig, MLAArgs
from repro_torch.nn.moe import MoEArgs

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv=128,
    d_ff=1536,
    vocab=102400,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_kind="rope",
    rope_theta=10_000.0,
    mla=MLAArgs(kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64, v_dim=128),
    moe=MoEArgs(num_experts=160, top_k=6, d_model=5120, d_ff=1536,
                shared_experts=2),
    first_k_dense=1,
    first_dense_ff=12288,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="deepseek-v2-236b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=48, vocab=512,
    mla=MLAArgs(kv_lora=16, q_lora=24, qk_nope=8, qk_rope=4, v_dim=8),
    moe=MoEArgs(num_experts=8, top_k=2, d_model=64, d_ff=48,
                shared_experts=1, capacity_factor=4.0),
    first_k_dense=1, first_dense_ff=128,
    param_dtype="float32", compute_dtype="float32",
)
