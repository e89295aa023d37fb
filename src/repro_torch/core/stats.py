"""The communication mechanism (paper §4.1): collect operation statistics.

Two realisations:

1. **Host-side** :class:`StatsCollector` — the JobTracker's hash map of
   per-Map-task statistics vectors, including §6's fault-tolerance
   semantics: statistics are keyed by *task id*, so re-executed or
   speculative attempts overwrite idempotently and exactly one entry per
   task survives.

2. **On-device** :func:`local_key_histogram` / :func:`global_key_distribution`
   — one histogram row of cluster ids per slot (the ``K^(i)`` vector of
   eq. 4-1), all slots in one kernel launch, then a sum over the slot
   axis: the TaskTracker→JobTracker aggregation.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import torch

from repro_torch.kernels.histogram import ops as hist_ops

__all__ = [
    "StatsCollector",
    "local_key_histogram",
    "global_key_distribution",
    "pair_weights",
]


class StatsCollector:
    """JobTracker-side aggregation with task-id idempotency (paper §6).

    >>> c = StatsCollector(num_clusters=4, num_map_tasks=2)
    >>> c.report(task_id=0, counts=[1, 0, 2, 0], attempt_id=0)
    >>> c.report(task_id=0, counts=[1, 0, 2, 0], attempt_id=1)  # speculative retry
    >>> c.report(task_id=1, counts=[0, 3, 0, 1])
    >>> c.complete
    True
    >>> c.aggregate().tolist()
    [1.0, 3.0, 2.0, 1.0]
    """

    def __init__(self, num_clusters: int, num_map_tasks: int):
        self.num_clusters = int(num_clusters)
        self.num_map_tasks = int(num_map_tasks)
        self._by_task: Dict[int, np.ndarray] = {}
        self.duplicate_reports = 0

    def report(
        self,
        task_id: int,
        counts,
        attempt_id: int = 0,
        success: bool = True,
    ) -> None:
        """Record one Map task attempt's statistics vector.

        Failed attempts are discarded by the TaskTracker (paper §6); multiple
        successful attempts of the same task keep exactly one entry.
        """
        if not success:
            return
        counts = np.asarray(counts, dtype=np.float64)
        if counts.shape != (self.num_clusters,):
            raise ValueError(
                f"stats vector must have shape ({self.num_clusters},), got {counts.shape}"
            )
        if task_id in self._by_task:
            self.duplicate_reports += 1
        self._by_task[task_id] = counts

    @property
    def complete(self) -> bool:
        """True once every Map task has reported (schedule may be computed)."""
        return len(self._by_task) >= self.num_map_tasks

    def aggregate(self) -> np.ndarray:
        """K = sum_i K^(i): the key (cluster) distribution of intermediate pairs."""
        if not self._by_task:
            return np.zeros(self.num_clusters)
        return np.sum(list(self._by_task.values()), axis=0)

    def reset(self) -> None:
        """Drop all collected statistics (new job on the same collector)."""
        self._by_task.clear()
        self.duplicate_reports = 0


# ---------------------------------------------------------------------------
# On-device statistics (all slots stacked on one device).
# ---------------------------------------------------------------------------


def local_key_histogram(
    cluster_ids: torch.Tensor,
    num_clusters: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-slot ``K^(i)`` (eq. 4-1): counts of pairs per cluster id.

    ``cluster_ids``: int tensor ``(m, ...)``, one row of pairs per slot;
    invalid entries may be marked by ``weights == 0``. A bool ``weights``
    (the validity mask phase A passes) stays a mask and takes the kernel's
    ``mask`` instance; any other weights become float32 (the ``float``
    instance); no weights count every pair (an all-true mask). Returns
    float32 ``(m, num_clusters)``. Goes through the histogram kernel on a
    CUDA tensor and through its plain version on a CPU one.
    """
    m = cluster_ids.shape[0]
    ids = cluster_ids.reshape(m, -1).to(torch.int32).contiguous()
    if weights is None:
        w = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    else:
        w = pair_weights(weights.reshape(m, -1))
    return hist_ops.histogram(ids, w, num_clusters)


def pair_weights(weights: torch.Tensor) -> torch.Tensor:
    """A bool mask as it is, anything else as float32; contiguous."""
    if weights.dtype != torch.bool:
        weights = weights.to(torch.float32)
    return weights.contiguous()


def global_key_distribution(local_hist: torch.Tensor) -> torch.Tensor:
    """The JobTracker sum: ``K = sum_i K^(i)`` over the slot axis."""
    return local_hist.sum(dim=0)
