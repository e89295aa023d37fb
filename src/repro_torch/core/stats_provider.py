"""Statistics layer: the exact per-slot histogram provider.

OS4M plans its global Reduce schedule from the per-shard key statistics
``K^(i)`` (paper §4.1). A **stats provider** owns

* the phase-A collection step (``collect`` — runs on the device over all
  slots, returns one ``(m, n)`` float32 tensor for exact statistics),
* the host-side estimator ``key_dist`` that turns the pulled state into
  the global ``(n,)`` cluster loads the scheduler balances.

:class:`ExactStats` is the only provider of the port so far: its state IS
the ``(m, n)`` histogram, and its global loads are the column sums. The
count-min sketch provider of the reference (``stats="sketch"``) is ROADMAP
Queue 1 item 5.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.stats import local_key_histogram

__all__ = ["ExactStats", "make_provider", "F32_EXACT_MAX"]

# Largest f32-representable integer count that is still exact (2^24 - 1);
# an on-device counter at/above this may have absorbed rounding error,
# so no statistics-sized bound survives past it.
F32_EXACT_MAX = float(2 ** 24) - 1.0


class ExactStats:
    """The exact ``(m, n)`` histogram provider.

    ``collect`` is :func:`repro_torch.core.stats.local_key_histogram`
    and the planner reads its state as pulled (no dtype cast), so plans
    match the reference's exact path.
    """

    kind = "exact"

    def __init__(self, num_clusters: int):
        self.num_clusters = int(num_clusters)

    def collect(self, cluster_ids, weights):
        """Phase-A step: the per-slot ``K^(i)`` rows, ``(m, n)`` float32."""
        return local_key_histogram(cluster_ids, self.num_clusters, weights=weights)

    def key_dist(self, state) -> np.ndarray:
        """Global cluster loads ``K``: shard-sum of the histograms."""
        h = np.asarray(state)
        return h.sum(axis=0) if h.ndim == 2 else h

    def params(self) -> Dict[str, int]:
        """Serializable provider parameters (none for exact)."""
        return {}


def make_provider(kind: str, num_clusters: int) -> ExactStats:
    """Build the provider named by ``MapReduceConfig.stats``."""
    if kind == "exact":
        return ExactStats(num_clusters)
    if kind == "sketch":
        raise NotImplementedError(
            "stats='sketch' (count-min statistics) is not ported yet:"
            " ROADMAP Queue 1 item 5")
    raise ValueError(f"unknown stats provider {kind!r}; use exact | sketch")
