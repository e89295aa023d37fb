"""Per-slot speed drift: the replan trigger for cached schedules.

The schedulers in :mod:`repro_torch.core.scheduler` accept a ``speeds`` vector —
relative processing rates per Reduce slot (1.0 = nominal). :func:`speed_drift`
compares two such vectors: a slot slowing (or recovering) by more than
``ReusePolicy.max_speed_drift`` invalidates a cached schedule the same way
key drift does.

The online estimator that produces ``speeds`` from phase-B wave timings
(``SlotSpeedEstimator`` in the reference) is not ported yet: it arrives with
ROADMAP Queue 1 item 6, where ``estimate_speeds`` first uses it.

Plain host numpy — speeds only move *where* clusters go, never what they
compute.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["speed_drift"]


def speed_drift(
    ref_speeds: Optional[Sequence[float]],
    new_speeds: Optional[Sequence[float]],
) -> float:
    """Largest fractional speed change of any slot between two estimates.

    ``max_j max(ref_j/new_j, new_j/ref_j) - 1`` — symmetric, so both a slot
    *slowing* (stale schedule now underestimates its finish time) and a
    slot *recovering* (capacity the schedule is not using) count. Returns
    0.0 for identical estimates; a slot dropping to half speed returns 1.0.

    ``None`` semantics: ``None`` means "no measurement". Two ``None`` sides
    (or ``None`` against an all-nominal vector) are zero drift — nothing
    was ever assumed, nothing can have changed. But a *one-sided* ``None``
    against a **non-nominal** vector is conservative ``inf``: the other
    side embodies a measured heterogeneity claim that can no longer be
    verified (an estimator ``reset()``, or a snapshot saved before any
    measurement), so a cached schedule built on it must be revalidated
    rather than silently trusted.

    **Dead slots (exact 0.0)** are structural, not drift: the ratio is
    taken only over slots *alive on both sides* — a slot dead on both
    sides contributes nothing (no rate to compare, and no 0/0 warning
    noise). If the *set* of dead slots differs between the two vectors
    (a slot died or rejoined), the function returns ``inf`` — a mesh-shape
    change always invalidates a plan — but callers that want to name the
    event precisely (``ReuseDecision`` reason ``"slot_dead"``) should
    compare dead masks *before* calling this.
    """
    if ref_speeds is None and new_speeds is None:
        return 0.0
    if ref_speeds is None or new_speeds is None:
        known = np.asarray(
            ref_speeds if ref_speeds is not None else new_speeds, np.float64
        )
        if known.size == 0 or np.allclose(known, 1.0, rtol=0.0, atol=1e-12):
            return 0.0          # None ≡ nominal: no evidence of change
        return float("inf")     # measured heterogeneity vs no measurement
    ref = np.asarray(ref_speeds, np.float64)
    new = np.asarray(new_speeds, np.float64)
    if ref.shape != new.shape:
        raise ValueError(f"speed shapes differ: {ref.shape} vs {new.shape}")
    if ref.size == 0:
        return 0.0
    ref_dead = ref == 0.0
    new_dead = new == 0.0
    if np.any(ref_dead != new_dead):
        return float("inf")     # structural: a slot died or rejoined
    both = ~ref_dead
    if not np.any(both):
        return 0.0              # degenerate: nothing alive to compare
    r, v = ref[both], new[both]
    ratio = np.maximum(r / v, v / r)
    return float(ratio.max() - 1.0)
