"""Online per-slot speed estimation from phase-B wave timings (Q||C_max).

The schedulers in :mod:`repro_torch.core.scheduler` accept a ``speeds`` vector —
relative processing rates per Reduce slot (1.0 = nominal). This module
produces that vector *online*: every executed batch yields one observation
``(work_j, seconds_j)`` per slot (pairs reduced and wall time of the slot's
phase-B waves), the estimator folds the implied rate ``work_j / seconds_j``
into a per-slot EWMA, and :meth:`SlotSpeedEstimator.speeds` returns the
rates normalised to mean 1 — a straggler running at half rate shows up as
``0.5`` regardless of the absolute unit the timings were measured in.

The feedback loop (``MapReduceJob``): measure phase B → ``update`` → the
next ``_plan`` assigns by earliest finish time under the new speeds →
measure again. :func:`speed_drift` is the replan trigger for cached
schedules: a slot slowing (or recovering) by more than
``ReusePolicy.max_speed_drift`` invalidates the snapshot the same way key
drift does.

Everything here is plain host numpy — speeds only move *where* clusters
go, never what they compute, so the estimator never touches device code.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np

__all__ = ["SlotSpeedEstimator", "speed_drift"]


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


@dataclasses.dataclass
class SlotSpeedEstimator:
    """EWMA estimate of per-slot relative processing speed.

    ``ewma``  — weight of the newest observation (1.0 = no smoothing; the
                default 0.4 converges on a step change in ~4 batches while
                riding out single-batch timing noise).
    ``floor`` — lower clamp on the *relative* speed, so one pathological
                timing sample cannot convince the scheduler a slot is
                10⁻⁶× and starve every other slot of its work.

    Slots with no observation yet report speed 1.0 (nominal). With zero
    observations :meth:`speeds` returns ``None`` — the schedulers' "assume
    P||C_max" signal — so a job without timing data behaves bit-identically
    to the speed-oblivious code.
    """

    num_slots: int
    ewma: float = 0.4
    floor: float = 0.05

    def __post_init__(self):
        """Validate knobs and reset the per-slot rate state."""
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError("ewma must be in (0, 1]")
        if not 0.0 < self.floor < 1.0:
            raise ValueError("floor must be in (0, 1)")
        self._rate = np.full(self.num_slots, np.nan)  # EWMA of work/second
        self._dead = np.zeros(self.num_slots, dtype=bool)
        self.observations = 0

    # -- elastic mesh --------------------------------------------------------

    def set_slot_failure(self, slot: int, dead: bool = True) -> None:
        """Mark ``slot`` dead (speed pinned to exact 0.0) or revived.

        Dead slots are masked out of every estimate: their measurements are
        dropped, :meth:`speeds` reports exactly ``0.0`` for them (the
        schedulers' "never assign here" signal), and the normalisation
        mean runs over the surviving slots only. Revival clears the slot's
        rate history — a rejoining device re-learns its speed from scratch
        (filling in at the observed-fleet mean meanwhile) instead of
        trusting a stale pre-failure estimate.
        """
        if not 0 <= slot < self.num_slots:
            raise ValueError(
                f"slot {slot} out of range for {self.num_slots} slots")
        if dead:
            self._dead[slot] = True
        elif self._dead[slot]:
            self._dead[slot] = False
            self._rate[slot] = np.nan

    @property
    def dead_mask(self) -> np.ndarray:
        """Boolean (num_slots,) — True where the slot is marked dead."""
        return self._dead.copy()

    def resize(self, num_slots: int) -> None:
        """Re-shape the estimator for an elastic mesh resize.

        Growth: new (highest-numbered) slots start unobserved and alive.
        Shrink: the highest-numbered slots' state is dropped. Slot identity
        below ``min(old, new)`` is preserved — rates and dead flags ride
        along, so a resize does not throw away warm measurements.
        """
        if num_slots <= 0:
            raise ValueError("num_slots must be positive")
        old = self.num_slots
        if num_slots == old:
            return
        rate = np.full(num_slots, np.nan)
        dead = np.zeros(num_slots, dtype=bool)
        keep = min(old, num_slots)
        rate[:keep] = self._rate[:keep]
        dead[:keep] = self._dead[:keep]
        self.num_slots = num_slots
        self._rate = rate
        self._dead = dead
        if self.observations and not np.any(~np.isnan(self._rate)):
            self.observations = 0  # every observed slot was dropped

    def update(
        self,
        slot_work: Sequence[float],
        slot_seconds: Sequence[float],
    ) -> np.ndarray:
        """Fold one batch's per-slot (work, wall seconds) into the estimate.

        Slots with no work or no measured time this batch keep their prior
        estimate (an idle slot tells us nothing about its speed). Zero,
        negative, or non-finite seconds/work are likewise skipped per slot
        — a ``seconds == 0`` sample (empty ``WaveTimings``, sub-tick wave
        on a coarse counter) would otherwise imply an infinite rate and
        poison the EWMA; a batch with no usable slot at all does not count
        as an observation. Returns the updated relative speed vector (see
        :meth:`speeds`).
        """
        work = np.asarray(slot_work, np.float64)
        secs = np.asarray(slot_seconds, np.float64)
        if work.shape != (self.num_slots,) or secs.shape != (self.num_slots,):
            raise ValueError(
                f"expected ({self.num_slots},) work/seconds, got "
                f"{work.shape}/{secs.shape}"
            )
        observed = (work > 0) & np.isfinite(work) & (secs > 0) & np.isfinite(secs)
        observed &= ~self._dead  # a dead slot's residual timings are noise
        rate = np.where(observed, work / np.maximum(secs, 1e-12), np.nan)
        first = observed & np.isnan(self._rate)
        cont = observed & ~np.isnan(self._rate)
        self._rate = np.where(first, rate, self._rate)
        self._rate = np.where(
            cont, self.ewma * rate + (1.0 - self.ewma) * self._rate, self._rate
        )
        if observed.any():
            self.observations += 1
        return self.speeds(default_ones=True)

    def speeds(self, default_ones: bool = False) -> Optional[np.ndarray]:
        """Relative speed per slot, normalised to mean 1 over the FULL vector.

        ``None`` before the first observation (unless ``default_ones``),
        which downstream code treats as "all slots nominal" — the exact
        P||C_max behaviour.

        Partially-observed fleets (pinned semantics): a slot with no
        observation yet is *assumed to run at the observed-fleet mean
        rate* — it fills in at exactly the mean before normalisation, so
        the returned mixed vector is mean-1 over **all** slots, not just
        the observed ones, and earliest-finish assignment is not biased
        toward (or away from) unobserved slots. The ``floor`` clamp is
        applied last and may perturb the mean by design — bounding the
        damage of one pathological timing sample outranks exact
        normalisation.

        Dead slots (:meth:`set_slot_failure`) report **exact 0.0** — below
        the floor by design, since the floor guards against bad timing
        samples while death is a structural fact — and are excluded from
        the mean, so the returned vector is mean-1 over the *surviving*
        slots. With dead slots present the result is never ``None``: even
        with zero timing observations the mesh shape itself is information
        the schedulers must see.
        """
        dead_any = bool(self._dead.any())
        if self.observations == 0:
            if dead_any:
                return np.where(self._dead, 0.0, 1.0)
            return np.ones(self.num_slots) if default_ones else None
        seen = ~np.isnan(self._rate) & ~self._dead
        if not np.any(seen):
            fallback = np.where(self._dead, 0.0, 1.0)
            return fallback if (dead_any or default_ones) else None
        mean = float(self._rate[seen].mean())
        if mean <= 0:
            fallback = np.where(self._dead, 0.0, 1.0)
            return fallback if (dead_any or default_ones) else None
        # Unobserved (alive) slots fill in at the observed mean, then the
        # alive portion is normalised by its own mean; dead slots pin at 0.
        rate_full = np.where(seen, self._rate, mean)
        alive = ~self._dead
        alive_mean = float(rate_full[alive].mean())
        rel = rate_full / alive_mean
        rel = np.clip(rel, self.floor, 1.0 / self.floor)
        return np.where(self._dead, 0.0, rel)

    def seed(self, speeds: Sequence[float]) -> None:
        """Adopt a known relative-speed vector as the initial estimate.

        The warm-start hook: a process restoring a persisted
        :class:`~repro_torch.core.schedule_cache.CachedSchedule` seeds the
        estimator with the snapshot's ``slot_speeds`` so the first drift
        check compares like with like instead of treating "no measurement
        yet" as unverifiable (:func:`speed_drift`'s conservative ``inf``).
        Counts as one observation; later measurements EWMA over it.
        """
        speeds = np.asarray(speeds, np.float64)
        if speeds.shape != (self.num_slots,):
            raise ValueError(
                f"expected ({self.num_slots},) speeds, got {speeds.shape}")
        if np.any(~np.isfinite(speeds)) or np.any(speeds < 0):
            raise ValueError(
                "seed speeds must be finite and >= 0 (0 = dead slot)")
        if not np.any(speeds > 0):
            raise ValueError("all slots dead: at least one speed must be > 0")
        # Exact zeros are dead-slot markers, not rates: they set the dead
        # mask (no rate history), matching normalize_speeds semantics.
        self._dead = speeds == 0.0
        self._rate = np.where(self._dead, np.nan, speeds)
        self.observations = 1

    def reset(self) -> None:
        """Forget every observation (speeds return to nominal).

        The dead mask survives — ``reset`` forgets *measurements*, not the
        mesh shape; use :meth:`set_slot_failure` to revive a slot.
        """
        self._rate = np.full(self.num_slots, np.nan)
        self.observations = 0

    # -- persistence (rides along CachedSchedule.to_json) -------------------

    def to_json(self) -> Dict[str, Any]:
        """Plain-type snapshot of the estimator state."""
        return {
            "num_slots": int(self.num_slots),
            "ewma": float(self.ewma),
            "floor": float(self.floor),
            "rate": [None if np.isnan(r) else float(r) for r in self._rate],
            "dead": [bool(d) for d in self._dead],
            "observations": int(self.observations),
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "SlotSpeedEstimator":
        """Rebuild an estimator from :meth:`to_json` output."""
        est = SlotSpeedEstimator(
            num_slots=int(d["num_slots"]),
            ewma=float(d["ewma"]),
            floor=float(d["floor"]),
        )
        est._rate = np.asarray(
            [np.nan if r is None else float(r) for r in d["rate"]], np.float64
        )
        dead = d.get("dead")  # absent in pre-elastic snapshots: all alive
        if dead is not None:
            est._dead = np.asarray([bool(x) for x in dead])
        est.observations = int(d["observations"])
        return est
