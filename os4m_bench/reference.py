"""The plain reference of a MapReduce ``sum`` job: per-cluster value sums,
sums of squares and pair counts in float64.

It reads only the batch the benchmark drew (key hashes, values, validity)
and works everything out again: a pair's cluster is ``|hash| mod n`` with
int32 semantics (``|INT32_MIN|`` wraps to itself, and the modulo is a
floor-mod, so every id lies in ``[0, n)``), and every valid pair adds its
values, their squares and a 1 to its cluster. The squares give each sum
its scale: rounding each value by a relative ``e`` moves a sum by about
``e`` times the root of its sum of squares. Slots are taken a block at a
time so that the float64 copies fit beside the batch. Plain PyTorch; it
imports nothing of the program.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

INT32_MIN = -(2 ** 31)


def cluster_ids(keys: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """int64 cluster id of every int32 key hash."""
    k = keys.to(torch.int64)
    return torch.remainder(torch.where(k == INT32_MIN, k, k.abs()), num_clusters)


def reduce_sum(keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor,
               num_clusters: int, block_slots: int = 4
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(sums (n, V), squares (n, V), counts (n,))`` in float64 of the
    valid pairs of ``keys (m, K)``, ``values (m, K, V)``, ``valid (m, K)``."""
    dev = values.device
    sums = torch.zeros((num_clusters, values.shape[-1]), dtype=torch.float64, device=dev)
    squares = torch.zeros_like(sums)
    counts = torch.zeros(num_clusters, dtype=torch.float64, device=dev)
    for r in range(0, keys.shape[0], block_slots):
        mask = valid[r:r + block_slots].to(torch.bool)
        cid = cluster_ids(keys[r:r + block_slots], num_clusters)[mask]
        rows = values[r:r + block_slots][mask].to(torch.float64)
        sums.index_add_(0, cid, rows)
        squares.index_add_(0, cid, rows.square_())
        counts.index_add_(0, cid, torch.ones_like(cid, dtype=torch.float64))
    return sums.cpu().numpy(), squares.cpu().numpy(), counts.cpu().numpy()
