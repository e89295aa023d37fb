"""Operation clustering (paper §4.3).

When the number of distinct Reduce keys ``n`` is large, OS4M groups keys into
*operation clusters* — the schedulable unit — to bound the network/compute
cost of the communication mechanism. The default algorithm puts keys ``a``
and ``b`` in the same cluster iff ``Hash(a) ≡ Hash(b) (mod n_target)``.

The paper's cost model (§4.3) is implemented verbatim in
:func:`network_cost_bytes` and validated by ``benchmarks/fig11_network.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

__all__ = [
    "cluster_ids_for_keys",
    "cluster_loads",
    "NetworkCost",
    "network_cost_bytes",
    "recommended_num_clusters",
]


def cluster_ids_for_keys(
    key_hashes: np.ndarray,
    n_target: int,
    custom: Optional[Callable[[np.ndarray, int], np.ndarray]] = None,
) -> np.ndarray:
    """Map (hashed) keys to cluster ids in ``[0, n_target)``.

    ``custom`` is the user-clustering hook the paper leaves as API; it must
    be a pure function ``(key_hashes, n_target) -> cluster_ids``.
    """
    if custom is not None:
        out = np.asarray(custom(key_hashes, n_target))
        if out.min(initial=0) < 0 or (out.size and out.max() >= n_target):
            raise ValueError("custom clustering produced ids outside [0, n_target)")
        return out.astype(np.int64)
    kh = np.abs(np.asarray(key_hashes, dtype=np.int64))
    return kh % np.int64(n_target)


def cluster_loads(
    key_loads: np.ndarray, cluster_ids: np.ndarray, n_clusters: int
) -> np.ndarray:
    """Aggregate per-key loads into per-cluster loads (exact, not sampled).

    The paper stresses (vs. Gufler et al. [G+12]) that cluster loads are
    *exact* sums of their member keys, which is what lets the scheduler be
    near-optimal.
    """
    return np.bincount(
        np.asarray(cluster_ids), weights=np.asarray(key_loads, dtype=np.float64),
        minlength=n_clusters,
    )


def recommended_num_clusters(num_reduce_slots: int, factor_lo: int = 6, factor_hi: int = 16) -> int:
    """Paper §5.4: best range is 6–16 clusters per Reduce slot; pick midpoint."""
    return num_reduce_slots * (factor_lo + factor_hi) // 2


@dataclasses.dataclass(frozen=True)
class NetworkCost:
    """Bytes moved by the §4.3 statistics collect + schedule broadcast."""

    collect_map_to_tt: int     # 8·M·n  — map ops -> TaskTrackers
    collect_tt_to_jt: int      # ≤ 8·M·n — TaskTrackers -> JobTracker
    broadcast_jt_to_tt: int    # 4·t·n
    broadcast_tt_to_task: int  # 4·r·n

    @property
    def collect_total(self) -> int:
        """Statistics-collection bytes (Map side up to the JobTracker)."""
        return self.collect_map_to_tt + self.collect_tt_to_jt

    @property
    def broadcast_total(self) -> int:
        """Schedule-broadcast bytes (JobTracker down to Reduce tasks)."""
        return self.broadcast_jt_to_tt + self.broadcast_tt_to_task

    @property
    def total(self) -> int:
        """Total mechanism overhead in bytes (paper bound: 4n(4M+t+r))."""
        return self.collect_total + self.broadcast_total


def network_cost_bytes(
    num_map_ops: int, num_clusters: int, num_tasktrackers: int, num_reduce_tasks: int
) -> NetworkCost:
    """Exact §4.3 cost model: total ≤ 4n(4M + t + r) bytes.

    ``long`` (8-byte) per-cluster counters in the collecting step, ``int``
    (4-byte) schedule entries in the broadcasting step.
    """
    M, n, t, r = num_map_ops, num_clusters, num_tasktrackers, num_reduce_tasks
    return NetworkCost(
        collect_map_to_tt=8 * M * n,
        collect_tt_to_jt=8 * M * n,
        broadcast_jt_to_tt=4 * t * n,
        broadcast_tt_to_task=4 * r * n,
    )
