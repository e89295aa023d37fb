"""MoE layer arguments (the reference's ``repro.nn.moe.MoEArgs``).

Only the dataclass is ported so far, because the model configurations
name it. The layer itself (dispatch, capacity slabs, OS4M expert
placement) and the mesh helpers of the reference's ``MoEArgs``
(``ep_size``, ``is_ep``, ``experts_per_shard``) wait for ROADMAP item 11.
"""

from __future__ import annotations

import dataclasses

__all__ = ["MoEArgs"]


@dataclasses.dataclass(frozen=True)
class MoEArgs:
    num_experts: int
    top_k: int
    d_model: int
    d_ff: int                      # per-expert hidden
    shared_experts: int = 0        # DeepSeek-style always-on experts
    act: str = "silu"
    gated: bool = True
    capacity_factor: float = 1.25  # slack over the *scheduled* max-load
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2
    # EP dispatch strategy: "a2a" (counting-sort into per-destination
    # buckets + all-to-all) or "broadcast" (every shard computes its
    # experts on all local tokens, psum combine).
    strategy: str = "a2a"
    # Chunked-dispatch pipelining: the a2a send buckets split into this
    # many capacity slabs (1 = single-shot a2a).
    pipeline_chunks: int = 1
