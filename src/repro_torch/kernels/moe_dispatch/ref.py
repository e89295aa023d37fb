"""Plain PyTorch versions of the dispatch kernel and the bucket scatter
(the reference's ``repro.kernels.moe_dispatch.ref``)."""

from __future__ import annotations

import torch


def dispatch_ranks_ref(dest: torch.Tensor, num_dests: int):
    """One-hot exclusive cumsum: ``(rank (T,), counts (E,))`` int32.

    ``rank[t] = #{t' < t : dest[t'] == dest[t]}``, -1 where ``dest[t]`` is
    not in ``[0, num_dests)``; ``counts[e] = #{t : dest[t] == e}``.
    """
    dest = dest.to(torch.int64)
    valid = (dest >= 0) & (dest < num_dests)
    d = torch.where(valid, dest, num_dests)
    onehot = (d[:, None] == torch.arange(num_dests, device=dest.device)[None, :]).to(
        torch.int64)
    excl = torch.cumsum(onehot, dim=0) - onehot
    rank = torch.where(valid, torch.sum(excl * onehot, dim=1), -1)
    counts = torch.sum(onehot, dim=0)
    return rank.to(torch.int32), counts.to(torch.int32)


def scatter_to_buckets(values: torch.Tensor, dest: torch.Tensor, rank: torch.Tensor,
                       counts: torch.Tensor, num_dests: int, capacity: int):
    """(T, V) values into (num_dests, capacity, V) buckets at their ranks;
    drop-newest. Returns ``(buckets, clamped counts, overflow)``."""
    ok = (rank >= 0) & (rank < capacity)
    flat = torch.where(ok, dest.to(torch.int64) * capacity + rank.to(torch.int64),
                       num_dests * capacity)
    out = torch.zeros((num_dests * capacity + 1, values.shape[-1]), dtype=values.dtype,
                      device=values.device)
    out[flat] = torch.where(ok[:, None], values, torch.zeros((), dtype=values.dtype,
                                                             device=values.device))
    buckets = out[:-1].reshape(num_dests, capacity, values.shape[-1])
    overflow = torch.sum(rank >= capacity).to(torch.int32)
    return buckets, torch.clamp(counts, max=capacity), overflow


def dispatch_to_buckets_ref(values: torch.Tensor, dest: torch.Tensor, num_dests: int,
                            capacity: int):
    """(T, V) values scattered to (num_dests, capacity, V); drop-newest."""
    rank, counts = dispatch_ranks_ref(dest, num_dests)
    return scatter_to_buckets(values, dest, rank, counts, num_dests, capacity)
