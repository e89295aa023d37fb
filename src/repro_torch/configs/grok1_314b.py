"""grok-1-314b [moe] — 8 experts top-2, GQA kv=8.

64L d_model=6144 48H (kv=8) d_ff=32768/expert vocab=131072  [hf:xai-org/grok-1]

DESIGN.md §Arch-applicability: 8 experts < 16-way model axis ⇒ the MoE runs
in the TP regime (expert hidden dim sliced over the model axis, dropless).
Per-shard load is inherently balanced there, so OS4M *placement* is
degenerate for this arch; the technique still governs the data-pipeline
packing and the serving lane scheduler.
"""

import dataclasses

from repro_torch.models.config import ModelConfig
from repro_torch.nn.moe import MoEArgs

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=32768,
    vocab=131072,
    norm="rmsnorm",
    act="gelu",
    gated_mlp=True,
    rope_kind="rope",
    rope_theta=10_000.0,
    moe=MoEArgs(num_experts=8, top_k=2, d_model=6144, d_ff=32768,
                act="gelu", gated=True),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="grok-1-314b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96, vocab=512,
    moe=MoEArgs(num_experts=4, top_k=2, d_model=64, d_ff=96,
                act="gelu", gated=True, capacity_factor=4.0),
    param_dtype="float32", compute_dtype="float32",
)
