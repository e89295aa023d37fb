"""smollm-360m [dense] — llama-arch small; also the base of the ~100M
end-to-end training example (examples/train_lm.py shrinks it further).

32L d_model=960 15H (kv=5) d_ff=2560 vocab=49152  [hf:HuggingFaceTB/SmolLM]
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv=5,
    d_ff=2560,
    vocab=49152,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_kind="rope",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="smollm-360m-smoke",
    n_layers=2, d_model=60, n_heads=3, n_kv=1, d_ff=160, vocab=512,
    param_dtype="float32", compute_dtype="float32",
)
