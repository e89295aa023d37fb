"""Public wrappers of the dispatch kernel (MoE / shuffle "copy" phase).

``dispatch_ranks`` launches ``csrc/moe_dispatch.cu`` on CUDA tensors
(counted in this module's ``launches``) and runs its plain version on CPU
tensors. The bucket scatter around it is plain tensor ops: one
known-index scatter, as XLA does it in the reference. This is the
reference's own entry point (``repro.kernels.moe_dispatch.ops``): no
engine or model path calls it, in the reference either, whose MoE layer
inlines its own sort (ROADMAP item 11).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import pipeline as pipe
from repro_torch.kernels.moe_dispatch.moe_dispatch import MAX_DESTS, dispatch_ranks_cuda
from repro_torch.kernels.moe_dispatch.ref import dispatch_ranks_ref, scatter_to_buckets

# Launches of the CUDA kernel since import (or since a caller reset it):
# +1 per call that runs the kernel (one launch), never for the plain version.
launches = 0


def dispatch_ranks(dest: torch.Tensor, num_dests: int):
    """Stable in-bucket rank per token + per-destination counts, int32.

    ``dest (T,)`` int32; ids outside ``[0, num_dests)`` get rank -1 and are
    not counted. CPU tensors run the plain version; CUDA tensors (int32,
    contiguous, 1 <= num_dests <= 1024, T < 2^31) launch the kernel or
    raise.
    """
    if dest.dim() != 1:
        raise ValueError(f"dispatch_ranks needs (T,) destinations, got {tuple(dest.shape)}")
    if dest.device.type == "cpu":
        return dispatch_ranks_ref(dest, num_dests)
    if dest.device.type != "cuda":
        raise ValueError(f"dispatch_ranks needs a CUDA (or CPU) tensor, got {dest.device}")
    if dest.dtype != torch.int32 or not dest.is_contiguous():
        raise TypeError(f"dispatch_ranks needs contiguous int32 destinations, got {dest.dtype}")
    if not 1 <= num_dests <= MAX_DESTS or dest.shape[0] >= 2 ** 31:
        raise ValueError(
            f"dispatch_ranks takes 1..{MAX_DESTS} destinations and fewer than 2^31"
            f" tokens, got {num_dests} and {dest.shape[0]}")
    rank = torch.empty_like(dest)
    if dest.shape[0] == 0:
        return rank, torch.zeros(num_dests, dtype=torch.int32, device=dest.device)
    counts = torch.empty(num_dests, dtype=torch.int32, device=dest.device)
    with torch.cuda.device(dest.device):
        dispatch_ranks_cuda(dest, rank, counts, num_dests)
    global launches
    launches += 1
    return rank, counts


def dispatch_to_buckets(values: torch.Tensor, dest: torch.Tensor, num_dests: int,
                        capacity: int):
    """Scatter (T, V) values into (num_dests, capacity, V) buckets.

    Tokens beyond a bucket's capacity are dropped (drop-newest: the
    deterministic policy the capacity bound of the OS4M schedule implies).
    Returns ``(buckets, clamped_counts, overflow)``.
    """
    rank, counts = dispatch_ranks(dest, num_dests)
    return scatter_to_buckets(values, dest, rank, counts, num_dests, capacity)


def plan_capacity_slabs(capacity: int, num_chunks: int) -> Tuple[Tuple[int, int], ...]:
    """Static (start, size) slabs cutting a bucket's capacity axis into
    pipeline chunks: ``pipeline.plan_chunks`` over uniform loads (before
    routing runs every capacity row is equally likely to be filled), so
    contiguous near-equal slabs."""
    if num_chunks <= 1 or capacity <= 1:
        return ((0, capacity),)
    chunks = pipe.plan_chunks([1.0] * capacity, num_chunks, "arrival")
    return tuple((int(c[0]), len(c)) for c in chunks)


def dispatch_to_buckets_chunked(values: torch.Tensor, dest: torch.Tensor, num_dests: int,
                                capacity: int, num_chunks: int):
    """Like :func:`dispatch_to_buckets`, pre-split into pipeline slabs.

    Returns ``(slabs, clamped_counts, overflow)`` where ``slabs`` is a tuple
    of ``(num_dests, size_c, V)`` views of the bucket tensor, one per chunk
    of :func:`plan_capacity_slabs`.
    """
    buckets, counts, overflow = dispatch_to_buckets(values, dest, num_dests, capacity)
    slabs = tuple(buckets[:, s:s + z] for s, z in plan_capacity_slabs(capacity, num_chunks))
    return slabs, counts, overflow
