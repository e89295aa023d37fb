"""qwen2-vl-7b [vlm] — M-RoPE (sections 16/24/24), GQA kv=4; the vision
frontend is a STUB (input_specs() provides (B, 256, d) patch embeddings
prepended to the text stream — dynamic resolution reduced to a fixed grid).

28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064  [arXiv:2409.12191; hf]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv=4,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_kind="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    n_patches=256,
    patch_grid=16,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen2-vl-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=512,
    mrope_sections=(4, 2, 2), n_patches=4, patch_grid=2,
    param_dtype="float32", compute_dtype="float32",
)
