"""xlstm-1.3b [ssm] — mLSTM + sLSTM blocks at 7:1 ratio; attention-free,
O(1)-state decode (runs long_500k).

48L d_model=2048 4H vocab=50304  [arXiv:2405.04517]

DESIGN.md §Arch-applicability: the paper's Reduce-operation scheduling has
no in-step analogue here (no routed/keyed units inside a layer); OS4M
applies via the data-pipeline packing only.
"""

import dataclasses

from repro_torch.models.config import ModelConfig
from repro_torch.nn.xlstm import XLSTMArgs

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv=4,
    d_ff=0,              # mLSTM blocks have no separate FFN
    vocab=50304,
    norm="rmsnorm",
    rope_kind="none",
    slstm_every=8,       # 7 mLSTM : 1 sLSTM
    # chunk=512: the 4-head × 1024² matrix memory makes the chunk-carry
    # stack the footprint driver; fewer, bigger chunks cut it 4×
    # (EXPERIMENTS.md §Dry-run).
    xlstm=XLSTMArgs(d_model=2048, n_heads=4, expand=2, chunk=512),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="xlstm-1.3b-smoke",
    n_layers=4, d_model=64, n_heads=2, slstm_every=2,
    vocab=512,
    xlstm=XLSTMArgs(d_model=64, n_heads=2, expand=2, chunk=16),
    param_dtype="float32", compute_dtype="float32",
)
