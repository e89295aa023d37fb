"""Balanced Subset Sum (BSS) — the per-slot sub-problem of the paper's scheduler.

The paper (§4.2, and the companion manuscript [F+14] arXiv:1401.0355) reduces
``P||C_max`` to a sequence of *Balanced Subset Sum* problems via dynamic
programming decomposition: for each slot in turn, select a subset of the
remaining operations whose total load is as close as possible to the balanced
target ``T = remaining_total / remaining_slots``.

We provide:

* :func:`bss_exact` — exact DP over achievable sums (weakly NP-hard /
  pseudo-polynomial), for small integer instances and as the test oracle.
* :func:`bss_approx` — FPTAS-style grid DP with relative error ``<= eta``,
  implemented with Python big-int bitsets so a 480-operation, ``eta=0.002``
  instance solves in milliseconds (paper Fig 10: < 0.5 s end to end).

Both return the *indices* of the chosen subset.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = ["bss_exact", "bss_approx", "subset_closest_to_target"]


def _reconstruct(units: Sequence[int], snapshots: List[int], g: int) -> List[int]:
    """Walk the per-item reachability snapshots backwards to recover a subset.

    ``snapshots[i]`` is the reachability bitset *after* considering items
    ``0..i-1`` (so ``snapshots[0] == 1``, only sum 0 reachable).
    """
    chosen: List[int] = []
    for i in range(len(units) - 1, -1, -1):
        before = snapshots[i]
        if (before >> g) & 1:
            # ``g`` was already reachable without item i — skip it.
            continue
        # Item i must be part of the subset.
        chosen.append(i)
        g -= units[i]
        assert g >= 0, "BSS reconstruction walked below zero"
    chosen.reverse()
    return chosen


def _bitset_dp(units: Sequence[int], bound: int) -> Tuple[int, List[int]]:
    """0/1 subset-sum reachability over ``[0, bound]`` with big-int bitsets.

    Returns ``(final_bitset, snapshots)`` where snapshots[i] is the bitset
    before item ``i`` was applied.
    """
    mask = (1 << (bound + 1)) - 1
    reach = 1  # only the empty sum
    snapshots: List[int] = []
    for u in units:
        snapshots.append(reach)
        if u <= bound:
            reach |= (reach << u) & mask
    return reach, snapshots


def _closest_bit(reach: int, target: int, bound: int) -> int:
    """Index of the set bit in ``reach`` closest to ``target`` (ties: lower)."""
    # One O(bits) conversion, then an outward scan over a flat string —
    # avoids O(bits) big-int shifts per probe.
    bits = bin(reach)[2:][::-1]  # bits[i] == '1'  <=>  sum i reachable
    n = len(bits)
    target = min(target, bound)
    for dist in range(0, bound + 1):
        lo = target - dist
        hi = target + dist
        if 0 <= lo < n and bits[lo] == "1":
            return lo
        if lo < 0 and hi >= n:
            break
        if hi < n and bits[hi] == "1":
            return hi
    # Sum 0 (empty subset) is always reachable.
    return 0


def subset_closest_to_target(
    units: Sequence[int], target: int, bound: int | None = None
) -> List[int]:
    """Exact: subset of ``units`` whose sum is closest to ``target``.

    ``bound`` caps the DP table (defaults to a small overshoot above target —
    any sum further above the target than the largest single item can never
    be closest).
    """
    if not units:
        return []
    if bound is None:
        bound = target + max(units)
    bound = max(bound, 1)
    reach, snaps = _bitset_dp(units, bound)
    g = _closest_bit(reach, min(target, bound), bound)
    return _reconstruct(units, snaps, g)


def bss_exact(loads: Sequence[float], target: float) -> List[int]:
    """Exact BSS for integer-ish loads (test oracle; pseudo-polynomial)."""
    units = [int(round(x)) for x in loads]
    if any(u < 0 for u in units):
        raise ValueError("loads must be non-negative")
    return subset_closest_to_target(units, int(round(target)))


def bss_approx(loads: Sequence[float], target: float, eta: float = 0.002) -> List[int]:
    """FPTAS-style BSS: subset with ``|sum - target| <= eta * target`` of optimal.

    Loads are rounded down onto a grid of ``delta = eta * target / k`` so the
    accumulated rounding error over at most ``k`` chosen items is bounded by
    ``eta * target``. The DP is a big-int bitset shift-or, O(k) shifts of a
    ``O(k/eta)``-bit integer.
    """
    k = len(loads)
    if k == 0:
        return []
    if target <= 0:
        return []
    if eta <= 0:
        return bss_exact(loads, target)
    delta = (eta * target) / k
    if delta <= 0:
        delta = 1.0
    units = [int(x / delta) for x in loads]
    tgt = int(target / delta)
    # Allow a modest overshoot window: a sum slightly above target can still
    # be the closest achievable one.
    bound = tgt + max(max(units), 1)
    reach, snaps = _bitset_dp(units, bound)
    g = _closest_bit(reach, tgt, bound)
    return _reconstruct(units, snaps, g)
