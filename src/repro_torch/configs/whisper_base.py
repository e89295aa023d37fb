"""whisper-base [audio] — encoder-decoder backbone; conv frontend is a STUB
(input_specs() provides precomputed (B, 1500, 512) frame embeddings).

6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865  [arXiv:2212.04356]

Decode shapes apply (enc-dec, not encoder-only): the decoder runs with its
self-KV cache plus the fixed 1500-frame cross-attention cache.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv=8,
    d_ff=2048,
    vocab=51865,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    rope_kind="none",
    abs_pos=True,
    enc_dec=True,
    n_enc_layers=6,
    enc_len=1500,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="whisper-base-smoke",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=512, enc_len=16,
    param_dtype="float32", compute_dtype="float32",
)
