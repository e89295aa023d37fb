"""Pluggable statistics layer: exact histograms or count-min sketches.

OS4M plans its global Reduce schedule from the per-shard key statistics
``K^(i)`` (paper §4.1). A **stats provider** owns

* the phase-A collection step (``collect`` — runs on the device over all
  slots in one kernel launch, returns one ``(m, state_size)`` float32
  tensor),
* the host-side estimators that turn pulled provider state back into
  the dense quantities the planner needs (``to_dense`` → per-shard
  ``(m, n)`` estimates, ``key_dist`` → the global ``(n,)`` cluster loads
  the scheduler balances), and
* the linear re-encoder ``from_dense`` (tests, synthetic statistics).

Two implementations:

:class:`ExactStats` — state IS the ``(m, n)`` histogram (the histogram
kernel); estimates are exact and plans match the reference's exact path.

:class:`SketchStats` — a count-min sketch. State is a ``(depth * width,)``
counter grid per shard (the sketch kernel); ``width`` is a power of two,
each row hashes cluster ids through an independent multiply-shift hash
``h_r(x) = (a_r * x mod 2^32) >> (32 - log2 width)`` with a fixed odd
multiplier ``a_r`` drawn on the host from a seeded RNG exactly as the
reference draws it, so both packages hash identically. Reading back takes
the **min over rows**, so every estimate is ``true + (non-negative
collision mass)``:

    overestimate-only:  est[j] >= true[j]          (always)
    error bound:        est[j] <= true[j] + e/width * N
                        with prob >= 1 - exp(-depth)   (N = total pairs)

The planner's send capacities are sized from these estimates, so
*overestimate-only* is the load-bearing property: a pure-sketch plan can
over-provision a buffer but never silently under-provision one. The one
caveat is float32 saturation — a counter cell at or beyond 2^24 may have
lost integer exactness on device, voiding the guarantee, which is why
the planner checks the RAW cell maximum (not the estimates) before
trusting any sketch-derived bound (``MapReduceJob._plan``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.stats import local_key_histogram, pair_weights
from repro_torch.kernels.sketch_hist import ops as sk_ops

__all__ = [
    "CountMinParams",
    "ExactStats",
    "SketchStats",
    "make_provider",
    "F32_EXACT_MAX",
]

# Largest f32-representable integer count that is still exact (2^24 - 1);
# an on-device counter at/above this may have absorbed rounding error,
# so no overestimate guarantee survives past it.
F32_EXACT_MAX = float(2 ** 24) - 1.0


def _check_width(width: int) -> int:
    width = int(width)
    if width < 8 or width & (width - 1):
        raise ValueError(
            f"sketch width must be a power of two >= 8, got {width}")
    return width


class CountMinParams:
    """The host-side count-min hash family (multipliers + binning).

    Deterministic given ``(width, depth, seed)`` — two processes (or the
    two packages) with the same parameters hash identically, which is what
    lets a persisted sketch snapshot (``CachedSchedule.to_json``) be
    re-estimated anywhere.
    """

    def __init__(self, width: int = 1024, depth: int = 4, seed: int = 0):
        self.width = _check_width(width)
        self.depth = int(depth)
        if self.depth < 1:
            raise ValueError(f"sketch depth must be >= 1, got {depth}")
        self.seed = int(seed)
        self.shift = 32 - (self.width.bit_length() - 1)
        rng = np.random.default_rng(self.seed)
        # Odd multipliers: multiply-shift needs a unit in Z/2^32.
        self.multipliers = (
            rng.integers(0, 2 ** 32, size=self.depth, dtype=np.uint64)
            .astype(np.uint32) | np.uint32(1)
        )

    def bin_ids(self, ids) -> np.ndarray:
        """Per-row bin of each id: ``(depth, len(ids))`` int64 in [0, width)."""
        ids_u = np.asarray(ids, np.int64).astype(np.uint32)
        bins = (self.multipliers[:, None] * ids_u[None, :]) >> np.uint32(
            self.shift)
        return bins.astype(np.int64)

    def add_dense(self, counters: np.ndarray, ids, weights) -> None:
        """Accumulate weighted ids into ``counters`` (depth, width), in place."""
        bins = self.bin_ids(ids)
        w = np.asarray(weights, np.float64)
        for r in range(self.depth):
            counters[r] += np.bincount(
                bins[r], weights=w, minlength=self.width)

    def estimate(self, counters: np.ndarray, ids) -> np.ndarray:
        """Count-min read: min over rows of each id's hashed cell (>= true)."""
        counters = np.asarray(counters, np.float64).reshape(
            self.depth, self.width)
        bins = self.bin_ids(ids)
        est = counters[0, bins[0]]
        for r in range(1, self.depth):
            est = np.minimum(est, counters[r, bins[r]])
        return est

    def to_json(self) -> Dict[str, int]:
        """The three integers that reproduce this hash family anywhere."""
        return {"width": self.width, "depth": self.depth, "seed": self.seed}

    @staticmethod
    def from_json(d: Dict[str, int]) -> "CountMinParams":
        """Rebuild the family from :meth:`to_json` output."""
        return CountMinParams(width=int(d["width"]), depth=int(d["depth"]),
                              seed=int(d.get("seed", 0)))


class ExactStats:
    """The exact ``(m, n)`` histogram provider.

    ``collect`` is :func:`repro_torch.core.stats.local_key_histogram`;
    every estimator is the identity, and the planner reads the state as
    pulled (no dtype cast), so plans match the reference's exact path.
    """

    kind = "exact"
    # Exact counts trivially satisfy "estimates never under-provision".
    overestimate_only = True

    def __init__(self, num_clusters: int):
        self.num_clusters = int(num_clusters)

    @property
    def state_size(self) -> int:
        """Per-shard state width: the full cluster histogram."""
        return self.num_clusters

    def collect(self, cluster_ids, weights):
        """Phase-A step: the per-slot ``K^(i)`` rows, ``(m, n)`` float32."""
        return local_key_histogram(cluster_ids, self.num_clusters, weights=weights)

    def to_dense(self, state) -> np.ndarray:
        """Per-shard dense counts: state already IS the histogram (no cast)."""
        return np.asarray(state)

    def key_dist(self, state) -> np.ndarray:
        """Global cluster loads ``K``: shard-sum of the histograms."""
        h = np.asarray(state)
        return h.sum(axis=0) if h.ndim == 2 else h

    def from_dense(self, hist) -> np.ndarray:
        """Provider state equivalent to having observed ``hist`` (identity)."""
        return np.asarray(hist)

    def params(self) -> Dict[str, int]:
        """Serializable provider parameters (none for exact)."""
        return {}


class SketchStats:
    """Count-min sketch provider: O(depth * width) state per shard.

    ``collect`` runs on the device inside phase A — the sketch kernel on a
    CUDA tensor, its plain version on a CPU one — and returns the
    flattened ``(m, depth * width)`` counter grids of every slot. All
    read-back estimation happens on the host from pulled counters
    (:class:`CountMinParams`).
    """

    kind = "sketch"
    # Count-min reads are min-over-rows of true + collision mass: they
    # can only overestimate (while the raw f32 cells stay exact — see
    # F32_EXACT_MAX and the planner's raw-counter guard).
    overestimate_only = True

    def __init__(self, num_clusters: int, width: int = 1024, depth: int = 4,
                 seed: int = 0):
        self.num_clusters = int(num_clusters)
        self.params_ = CountMinParams(width=width, depth=depth, seed=seed)
        if self.depth > sk_ops.MAX_DEPTH:
            raise ValueError(
                f"sketch depth must be <= {sk_ops.MAX_DEPTH}, got {depth}")
        self._bins: Optional[np.ndarray] = None  # cached (depth, n)

    @property
    def width(self) -> int:
        """Counter columns per hash row (power of two)."""
        return self.params_.width

    @property
    def depth(self) -> int:
        """Independent hash rows (estimate = min across them)."""
        return self.params_.depth

    @property
    def state_size(self) -> int:
        """Per-shard state width: the flattened counter grid."""
        return self.depth * self.width

    def bins(self) -> np.ndarray:
        """Cached per-row bin of every cluster id: (depth, n) int64."""
        if self._bins is None:
            self._bins = self.params_.bin_ids(np.arange(self.num_clusters))
        return self._bins

    def collect(self, cluster_ids: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """Phase-A step: ``(m, depth * width)`` float32 counters, one launch.

        A bool ``weights`` (phase A's validity mask) takes the kernel's
        ``mask`` instance, any other the ``float`` one (as float32).
        """
        m = cluster_ids.shape[0]
        ids = cluster_ids.reshape(m, -1).to(torch.int32).contiguous()
        w = pair_weights(weights.reshape(m, -1))
        counters = sk_ops.sketch_hist(ids, w, self.params_.multipliers, self.width)
        return counters.reshape(m, -1)

    def to_dense(self, state) -> np.ndarray:
        """Per-shard count-min estimates: (m, state) -> (m, n), each >= true.

        Vectorized min-over-rows gather; accepts a single flat state
        vector too (returns (n,)).
        """
        cells = np.asarray(state, np.float64)
        squeeze = cells.ndim == 1
        cells = cells.reshape(-1, self.depth, self.width)
        bins = self.bins()
        est = cells[:, 0, bins[0]]
        for r in range(1, self.depth):
            est = np.minimum(est, cells[:, r, bins[r]])
        return est[0] if squeeze else est

    def key_dist(self, state) -> np.ndarray:
        """Global cluster-load estimate ``K``: estimate over summed counters.

        Counters are summed over shards *before* the min-over-rows read.
        That matches the steady-state reuse path, which reduces the
        sketch on the device and pulls only the ``(depth * width,)``
        global counters — so the global estimate is identical whether it
        came from full per-shard state or from the reduced pull. Still
        overestimate-only: summed cells are summed ``true + collision``
        masses.
        """
        cells = np.asarray(state, np.float64)
        if cells.ndim == 2:
            cells = cells.sum(axis=0)
        return self.to_dense(cells)

    def send_bound(self, state, dests, members, num_slots: int) -> float:
        """Worst per-(shard, dest) send overestimate for one wave.

        For hash row ``r``, the pairs shard ``i`` can send destination
        ``d`` are bounded by the sum of ``cells[i, r, b]`` over the
        *distinct* bins ``b`` that ``d``'s wave members hash into — every
        member's true count is contained in its bin's cell, and a bin
        shared by several members is counted once. The bound is ``max
        over (i, d)`` of ``min over rows``, at a cost of O(depth ·
        (|members| + m · num_slots · width)), independent of the cluster
        count.
        """
        members = np.asarray(members, np.int64)
        if members.size == 0:
            return 0.0
        cells = np.asarray(state, np.float64).reshape(
            -1, self.depth, self.width)
        dests = np.asarray(dests, np.int64)
        bins = self.bins()[:, members]                # (depth, |M|)
        mask = np.zeros((self.depth, int(num_slots), self.width))
        for r in range(self.depth):
            mask[r, dests, bins[r]] = 1.0
        # S[r, i, d] = row-r mass shard i holds in d's distinct bins
        per_dest = np.einsum("irw,rdw->rid", cells, mask)
        return float(per_dest.min(axis=0).max())

    def from_dense(self, hist) -> np.ndarray:
        """Provider state equivalent to having observed ``hist`` exactly.

        Count-min is linear in its input stream, so sketching a dense
        histogram row is one bincount of the cluster bins weighted by
        the row.
        """
        h = np.asarray(hist, np.float64)
        squeeze = h.ndim == 1
        h = h.reshape(-1, self.num_clusters)
        bins = self.bins()
        out = np.zeros((h.shape[0], self.depth, self.width))
        for i in range(h.shape[0]):
            for r in range(self.depth):
                out[i, r] = np.bincount(
                    bins[r], weights=h[i], minlength=self.width)
        out = out.reshape(h.shape[0], -1)
        return out[0] if squeeze else out

    def params(self) -> Dict[str, int]:
        """Serializable provider parameters (hash family reproduction)."""
        return self.params_.to_json()


def make_provider(kind: str, num_clusters: int, *, width: int = 1024,
                  depth: int = 4, seed: int = 0):
    """Build the provider named by ``MapReduceConfig.stats``."""
    if kind == "exact":
        return ExactStats(num_clusters)
    if kind == "sketch":
        return SketchStats(num_clusters, width=width, depth=depth, seed=seed)
    raise ValueError(f"unknown stats provider {kind!r}; use exact | sketch")
