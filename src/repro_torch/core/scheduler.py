"""``Q||C_max`` / ``R||C_max`` schedulers for operation-level load balance.

The scheduling problem (paper §3.2, §4.2): assign ``n`` Reduce operations
(or operation clusters) with loads ``k_1..k_n`` to ``m`` slots minimising
the makespan. The paper treats the identical-slots case ``P||C_max``
(strongly NP-hard [Ho98]); real fleets have stragglers and mixed device
generations, so every strategy here generalises to *uniform machines*
``Q||C_max``: slot ``j`` processes load at relative speed ``s_j`` (1.0 =
nominal) and an operation of load ``w`` placed on it contributes
``w / s_j`` of *finish time*. ``speeds=None`` (or all-ones) recovers
``P||C_max`` exactly — assignments are bit-identical to the
speed-oblivious algorithms, which the golden regression test pins.

Multi-job fleets generalise one step further, to *unrelated processors*
``R||C_max`` (Fotakis et al., arXiv 1312.4203): operation ``j`` on slot
``i`` takes an arbitrary processing time ``p[j, i]`` — different jobs see
different relative slot speeds (cache residency, NUMA placement, expert
affinity), so no single speed vector explains the matrix. ``lpt`` /
``multifit`` / ``brute`` accept ``proc_times=`` (an ``(n, m)`` matrix;
``+inf`` marks a slot that cannot run the operation — an all-``inf``
column is the PR 6 dead-slot mask in matrix form), and
:func:`schedule_unrelated` adds the R-native EFT-greedy + local-search
strategy. ``speeds=`` remains the rank-1 special case: a matrix that
factors **exactly** as ``loads ⊗ (1/speeds)`` is detected
(:func:`factor_rank1_proc_times`) and delegated to the unchanged
``Q||C_max`` code path, so rank-1 ``proc_times`` reproduce the pinned
``speeds=`` assignments bit-for-bit (exactly so when speed ratios are
powers of two, where binary floating point scaling is lossless).

Implemented strategies (all return a :class:`Schedule`):

* :func:`schedule_hash`      — the MapReduce default, eq. (3-1): ``Hash(k) mod m``.
                               Speed-*oblivious* by design: the baseline.
* :func:`schedule_lpt`       — Graham's Longest Processing Time, placing each
                               operation on the slot with the earliest finish
                               time (4/3-approx on P, 2-approx on Q).
* :func:`schedule_multifit`  — MULTIFIT (binary search on a finish-time
                               deadline; slot capacity = deadline × speed).
* :func:`schedule_bss`       — the paper's algorithm: dynamic programming
                               decomposition into per-slot Balanced Subset Sum
                               problems with speed-proportional targets,
                               solved with an ``eta``-FPTAS.
* :func:`schedule_brute`     — exact branch-and-bound over finish times for
                               tiny instances (test oracle).
* :func:`lpt_assign_torch`   — earliest-finish-time LPT as tensor ops on the
                               loads' device (sort + a loop of argmins), so a
                               step can re-balance without leaving the device.

Loads are "number of key-value pairs" in the paper; here any non-negative
measure (tokens routed to an expert, document lengths, request decode
budgets). Speeds come from :mod:`repro.core.slot_speeds` (online EWMA
estimation from phase-B wave timings) or are passed explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.core import bss as _bss

__all__ = [
    "Schedule",
    "normalize_speeds",
    "normalize_proc_times",
    "factor_rank1_proc_times",
    "rank1_proc_times",
    "proc_dead_slots",
    "schedule_hash",
    "schedule_lpt",
    "schedule_multifit",
    "schedule_bss",
    "schedule_brute",
    "schedule_unrelated",
    "get_scheduler",
    "lpt_assign_torch",
    "SCHEDULERS",
    "AUTO_CANDIDATES",
]


def normalize_speeds(
    speeds: Optional[Sequence[float]], num_slots: int
) -> Optional[np.ndarray]:
    """Validate a ``speeds`` argument: None stays None (≡ all slots nominal).

    Returns a float64 ``(num_slots,)`` array of non-negative relative
    speeds, or ``None``. Strategies treat ``None`` and all-ones identically.
    An **exact 0.0 means the slot is dead** (vanished from the mesh): every
    strategy excludes it from assignment entirely — elastic-mesh semantics,
    not "infinitely slow". Negative / non-finite speeds and an all-zero
    vector (no slot can make progress) are rejected.
    """
    if speeds is None:
        return None
    speeds = np.asarray(speeds, dtype=np.float64)
    if speeds.shape != (num_slots,):
        raise ValueError(
            f"speeds must have shape ({num_slots},), got {speeds.shape}"
        )
    if np.any(~np.isfinite(speeds)) or np.any(speeds < 0):
        raise ValueError("slot speeds must be finite and >= 0 (0 = dead slot)")
    if speeds.size and not np.any(speeds > 0):
        raise ValueError("all slots dead: at least one speed must be > 0")
    return speeds


def _dead_slot_split(
    speeds: Optional[Sequence[float]], num_slots: int
):
    """``(alive_idx, compact_speeds)`` when dead (speed-0) slots exist, else None.

    The strategies use this to *compact* the instance onto the surviving
    slots, run the unchanged all-alive algorithm there, and remap the
    assignment back through ``alive_idx`` — so a dead slot never receives
    work and the all-alive code paths stay bit-identical.
    """
    s = normalize_speeds(speeds, num_slots)
    if s is None or not np.any(s == 0.0):
        return None
    alive = np.flatnonzero(s > 0.0)
    return alive, s[alive]


# ---------------------------------------------------------------------------
# R||C_max: per-(operation, slot) processing-time matrices.
# ---------------------------------------------------------------------------


def normalize_proc_times(
    proc_times: Optional[Sequence[Sequence[float]]],
    num_ops: int,
    num_slots: int,
) -> Optional[np.ndarray]:
    """Validate a ``proc_times`` argument: None stays None (≡ speeds path).

    Returns a float64 ``(num_ops, num_slots)`` matrix ``p`` where
    ``p[j, i]`` is the time operation ``j`` takes on slot ``i``.
    ``+inf`` means "slot i cannot run operation j"; a column of all
    ``inf`` is a **dead slot** (the matrix form of the speed-0
    convention). NaN and negative entries are rejected, as is any
    operation with no finite slot (it could never complete anywhere).
    """
    if proc_times is None:
        return None
    p = np.asarray(proc_times, dtype=np.float64)
    if p.shape != (num_ops, num_slots):
        raise ValueError(
            f"proc_times must have shape ({num_ops}, {num_slots}), "
            f"got {p.shape}"
        )
    if np.any(np.isnan(p)) or np.any(p < 0):
        raise ValueError(
            "proc_times must be >= 0 or +inf (inf = slot cannot run op)")
    if num_ops and not np.all(np.isfinite(p).any(axis=1)):
        raise ValueError(
            "every operation needs at least one finite-time slot")
    return p


def proc_dead_slots(proc_times: np.ndarray) -> np.ndarray:
    """Boolean dead-slot mask of a proc-time matrix: all-``inf`` columns."""
    p = np.asarray(proc_times, dtype=np.float64)
    if p.shape[0] == 0:
        return np.zeros(p.shape[1], dtype=bool)
    return ~np.isfinite(p).any(axis=0)


def rank1_proc_times(
    loads: Sequence[float],
    speeds: Optional[Sequence[float]],
    num_slots: int,
) -> np.ndarray:
    """Build the rank-1 ``(n, m)`` matrix ``p[j, i] = loads[j] / speeds[i]``.

    The Q||C_max instance written in R||C_max form; a dead slot (speed
    exactly 0.0) becomes an all-``inf`` column. This is the canonical way
    to hand a uniform-machines instance to a ``proc_times=`` code path.
    """
    loads = np.asarray(loads, dtype=np.float64)
    s = _speeds_or_ones(speeds, num_slots)
    with np.errstate(divide="ignore"):
        p = loads[:, None] / s[None, :]
    if np.any(s == 0.0):
        p[:, s == 0.0] = np.inf
    return p


def factor_rank1_proc_times(proc_times: np.ndarray):
    """Exactly factor ``p`` as ``loads ⊗ (1/speeds)``; None if not rank-1.

    Returns ``(loads, speeds)`` with the first alive slot pinned to speed
    1.0 and dead (all-``inf``) columns mapped to speed 0.0, **iff** the
    reconstruction ``loads[:, None] / speeds`` reproduces ``p`` bit for
    bit. The check is exact float equality, not a tolerance: a true
    rank-1 matrix built by :func:`rank1_proc_times` with power-of-two
    speed ratios round-trips losslessly (binary scaling), so the Q||C_max
    delegation below is bit-identical to the ``speeds=`` path, while a
    genuinely unrelated matrix falls through to the R-native algorithms.
    """
    p = np.asarray(proc_times, dtype=np.float64)
    n, m = p.shape
    if n == 0 or m == 0:
        return None
    dead = proc_dead_slots(p)
    alive = np.flatnonzero(~dead)
    if alive.size == 0:
        return None
    i0 = int(alive[0])
    loads = p[:, i0]
    if not np.all(np.isfinite(loads)):
        return None  # partial-inf column: per-op incompatibility, not rank-1
    speeds = np.zeros(m, dtype=np.float64)
    speeds[i0] = 1.0
    # The reference row: the largest load pins each column's speed ratio.
    j0 = int(np.argmax(loads))
    if loads[j0] == 0.0:
        # All-zero loads: any assignment has makespan 0; treat as uniform.
        if np.all(p[:, alive] == 0.0):
            speeds[alive] = 1.0
            return loads, speeds
        return None
    for i in alive[1:]:
        col = p[:, i]
        if not np.all(np.isfinite(col)) or col[j0] == 0.0:
            return None
        speeds[i] = loads[j0] / col[j0]
        if not np.array_equal(col, loads / speeds[i]):
            return None
    return loads, speeds


def _proc_or_none(proc_times, loads, num_slots):
    """Validated proc-time matrix, or None when the speeds path applies."""
    return normalize_proc_times(
        proc_times, np.asarray(loads).shape[0], num_slots)


def _require_one_speed_source(speeds, proc_times) -> None:
    """``speeds=`` and ``proc_times=`` are mutually exclusive inputs."""
    if speeds is not None and proc_times is not None:
        raise ValueError(
            "pass speeds= (uniform machines) or proc_times= (unrelated "
            "processors), not both — rank1_proc_times(loads, speeds, m) "
            "embeds a speed vector into the matrix form")


def _eft_r(p: np.ndarray) -> np.ndarray:
    """Earliest-finish-time greedy on unrelated processors.

    Operations in descending order of their best-case (min over slots)
    processing time; each goes to ``argmin_i (T_i + p[j, i])`` where
    ``T_i`` is the slot's accumulated finish time. ``inf`` entries (dead
    or incompatible slots) can never win the argmin because every
    operation has a finite-time slot.
    """
    n, m = p.shape
    best_case = np.min(p, axis=1)
    order = np.argsort(-best_case, kind="stable")
    assignment = np.zeros(n, dtype=np.int32)
    finish = np.zeros(m, dtype=np.float64)
    for j in order:
        slot = int(np.argmin(finish + p[j]))
        assignment[j] = slot
        finish[slot] += p[j, slot]
    return assignment


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Result of scheduling ``n`` operations onto ``m`` (possibly uneven) slots.

    Derived metrics come in two spaces:

    * load space (the paper's P||C_max view): ``slot_loads`` / ``max_load``
      / ``balance_ratio`` — what each slot *holds*;
    * finish-time space (Q||C_max): ``slot_finish = slot_loads /
      slot_speeds``, ``makespan`` (the job's completion time) and
      ``finish_ratio = makespan / ideal_finish`` — what each slot *takes*.

    With uniform speeds the two coincide (``makespan == max_load``).
    An R||C_max schedule additionally carries the ``proc_times`` matrix it
    was built from; finish-time metrics then sum the per-operation
    processing times actually paid on each slot instead of dividing load
    by a speed. Direct construction ``Schedule(assignment, num_slots)``
    is valid: ``__post_init__`` derives ``slot_loads`` from unit
    operation loads and defaults speeds to nominal, so no field is ever
    left ``None``.
    """

    assignment: np.ndarray  # (n,) int32 — slot id per operation
    num_slots: int

    # --- derived (computed in __post_init__ when not given) ---------------
    slot_loads: Optional[np.ndarray] = None   # (m,) load held per slot
    slot_speeds: Optional[np.ndarray] = None  # (m,) relative speed, 1 = nominal
    proc_times: Optional[np.ndarray] = None   # (n, m) R||C_max time matrix

    def __post_init__(self):
        """Normalise arrays and derive missing metrics (unit loads, nominal speeds)."""
        assignment = np.asarray(self.assignment, dtype=np.int32)
        object.__setattr__(self, "assignment", assignment)
        if self.slot_loads is None:
            loads = np.bincount(assignment, minlength=self.num_slots)
            object.__setattr__(
                self, "slot_loads", loads[: self.num_slots].astype(np.float64)
            )
        else:
            object.__setattr__(
                self, "slot_loads", np.asarray(self.slot_loads, np.float64)
            )
        if self.slot_speeds is None:
            object.__setattr__(self, "slot_speeds", np.ones(self.num_slots))
        else:
            object.__setattr__(
                self, "slot_speeds",
                normalize_speeds(self.slot_speeds, self.num_slots),
            )
        if self.proc_times is not None:
            object.__setattr__(
                self, "proc_times",
                normalize_proc_times(
                    self.proc_times, assignment.shape[0], self.num_slots),
            )

    @staticmethod
    def from_assignment(
        assignment: np.ndarray,
        loads: np.ndarray,
        num_slots: int,
        speeds: Optional[Sequence[float]] = None,
    ) -> "Schedule":
        """Build a Schedule (with derived metrics) from an assignment."""
        assignment = np.asarray(assignment, dtype=np.int32)
        loads = np.asarray(loads, dtype=np.float64)
        slot_loads = np.bincount(assignment, weights=loads, minlength=num_slots)
        return Schedule(
            assignment=assignment,
            num_slots=num_slots,
            slot_loads=slot_loads,
            slot_speeds=normalize_speeds(speeds, num_slots),
        )

    @staticmethod
    def from_proc_assignment(
        assignment: np.ndarray,
        loads: np.ndarray,
        proc_times: np.ndarray,
        num_slots: int,
    ) -> "Schedule":
        """Build an R||C_max Schedule: finish metrics come from the matrix.

        ``slot_speeds`` records the dead-slot mask (alive = 1.0, dead =
        0.0) so speed-vector consumers see the structural facts, while the
        real finish times sum ``proc_times[j, assignment[j]]`` per slot.
        """
        assignment = np.asarray(assignment, dtype=np.int32)
        loads = np.asarray(loads, dtype=np.float64)
        p = normalize_proc_times(proc_times, loads.shape[0], num_slots)
        slot_loads = np.bincount(assignment, weights=loads, minlength=num_slots)
        speeds = np.where(proc_dead_slots(p), 0.0, 1.0) if p is not None \
            else None
        return Schedule(
            assignment=assignment,
            num_slots=num_slots,
            slot_loads=slot_loads,
            slot_speeds=speeds,
            proc_times=p,
        )

    # --- load space (P||C_max view) ---------------------------------------

    @property
    def max_load(self) -> float:
        """Largest load held by any slot (speed-blind)."""
        return float(self.slot_loads.max()) if self.num_slots else 0.0

    @property
    def ideal_load(self) -> float:
        """Perfectly even split of the total load."""
        if not self.num_slots:
            return 0.0
        return float(self.slot_loads.sum()) / self.num_slots

    @property
    def balance_ratio(self) -> float:
        """max-load / ideal-load (paper Fig 6; 1.0 is perfect)."""
        if self.ideal_load == 0:
            return 1.0
        return self.max_load / self.ideal_load

    # --- finish-time space (Q||C_max view) --------------------------------

    @property
    def slot_finish(self) -> np.ndarray:
        """Per-slot completion time: ``slot_loads / slot_speeds``.

        A dead slot (speed 0) finishes at 0 when it holds no load — the
        invariant every strategy maintains — and at ``inf`` when it does
        (work stranded on a vanished slot never completes). An R||C_max
        schedule instead sums the processing times each slot actually
        pays: ``Σ_j proc_times[j, i]`` over its assigned operations ``j``
        (an ``inf`` entry — op landed on a slot that cannot run it —
        correctly reads as never finishing).
        """
        if self.proc_times is not None:
            paid = self.proc_times[
                np.arange(self.assignment.shape[0]), self.assignment]
            return np.bincount(
                self.assignment, weights=paid, minlength=self.num_slots
            )[: self.num_slots]
        with np.errstate(divide="ignore", invalid="ignore"):
            finish = self.slot_loads / self.slot_speeds
        dead = self.slot_speeds == 0.0
        if np.any(dead):
            finish = np.where(dead & (self.slot_loads == 0.0), 0.0, finish)
            finish = np.where(dead & (self.slot_loads > 0.0), np.inf, finish)
        return finish

    @property
    def makespan(self) -> float:
        """Job completion time: the slowest slot's finish time."""
        return float(self.slot_finish.max()) if self.num_slots else 0.0

    @property
    def ideal_finish(self) -> float:
        """Lower bound on the makespan any schedule could reach.

        Uniform machines: total load spread over the aggregate speed.
        Unrelated processors: the classic pair of R||C_max bounds — the
        best-case times spread over the alive slots, and the single
        worst operation at its best slot.
        """
        if self.proc_times is not None:
            if self.assignment.shape[0] == 0:
                return 0.0
            best_case = np.min(self.proc_times, axis=1)
            alive = int((self.slot_speeds > 0.0).sum())
            if alive == 0:
                return 0.0
            return float(max(best_case.sum() / alive, best_case.max()))
        total_speed = float(self.slot_speeds.sum()) if self.num_slots else 0.0
        if total_speed == 0:
            return 0.0
        return float(self.slot_loads.sum()) / total_speed

    @property
    def finish_ratio(self) -> float:
        """makespan / ideal-finish — the speed-normalised balance_ratio."""
        if self.ideal_finish == 0:
            return 1.0
        return self.makespan / self.ideal_finish

    @property
    def rel_std(self) -> float:
        """std(slot finish times) / mean — heterogeneity-aware error bar."""
        finish = self.slot_finish
        mean = finish.mean()
        if mean == 0:
            return 0.0
        return float(finish.std() / mean)


def _speeds_or_ones(speeds: Optional[Sequence[float]], num_slots: int) -> np.ndarray:
    """Concrete speed vector for the assignment loops (None → nominal)."""
    s = normalize_speeds(speeds, num_slots)
    return np.ones(num_slots) if s is None else s


# ---------------------------------------------------------------------------
# Baseline: the MapReduce default hash partitioner (paper eq. 3-1).
# ---------------------------------------------------------------------------


def _default_hash(keys: np.ndarray) -> np.ndarray:
    """A deterministic integer mix (64-bit splitmix-style) of the key ids.

    Using the identity here would make ``key mod m`` artificially uniform for
    dense key ids; a real partitioner hashes, so we hash.
    """
    k = np.asarray(keys, dtype=np.uint64)
    k = (k ^ (k >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    k = (k ^ (k >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    k = k ^ (k >> np.uint64(31))
    return k


def schedule_hash(
    loads: Sequence[float],
    num_slots: int,
    keys: Optional[np.ndarray] = None,
    hash_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    speeds: Optional[Sequence[float]] = None,
    proc_times: Optional[Sequence[Sequence[float]]] = None,
) -> Schedule:
    """Default MapReduce partitioning: ``i = |Hash(k)| mod m`` (eq. 3-1).

    Oblivious to both load *and* speed — the assignment ignores ``speeds``
    entirely (that is the point of the baseline); they are only recorded on
    the returned :class:`Schedule` so its finish-time metrics are honest.
    With ``proc_times=`` the baseline stays oblivious to the matrix values
    but still respects the structural dead-slot mask (an all-``inf``
    column receives nothing — hashing work onto a vanished slot is not a
    baseline, it is a bug).
    """
    loads = np.asarray(loads, dtype=np.float64)
    _require_one_speed_source(speeds, proc_times)
    n = loads.shape[0]
    if keys is None:
        keys = np.arange(n)
    hashed = (hash_fn or _default_hash)(np.asarray(keys))
    p = _proc_or_none(proc_times, loads, num_slots)
    if p is not None:
        dead_mask = proc_dead_slots(p)
        if np.any(dead_mask):
            alive = np.flatnonzero(~dead_mask)
            idx = (hashed % np.uint64(alive.size)).astype(np.int64)
            assignment = alive[idx].astype(np.int32)
        else:
            assignment = (hashed % np.uint64(num_slots)).astype(np.int32)
        return Schedule.from_proc_assignment(assignment, loads, p, num_slots)
    dead = _dead_slot_split(speeds, num_slots)
    if dead is not None:
        # Elastic mesh: hash onto the surviving slots only (mod num_alive,
        # remapped to the alive slot ids) — still load- and speed-oblivious
        # among the living, but a vanished slot receives nothing.
        alive, _ = dead
        idx = (hashed % np.uint64(alive.size)).astype(np.int64)
        assignment = alive[idx].astype(np.int32)
    else:
        assignment = (hashed % np.uint64(num_slots)).astype(np.int32)
    return Schedule.from_assignment(assignment, loads, num_slots, speeds=speeds)


# ---------------------------------------------------------------------------
# Graham's LPT, earliest-finish-time variant (host-side).
# ---------------------------------------------------------------------------


def schedule_lpt(
    loads: Sequence[float],
    num_slots: int,
    speeds: Optional[Sequence[float]] = None,
    proc_times: Optional[Sequence[Sequence[float]]] = None,
) -> Schedule:
    """Longest Processing Time first, placed by earliest finish time.

    Each operation (descending load) goes to the slot where it would
    *complete* soonest: ``argmin_j (load_j + w) / s_j``. With uniform
    speeds this is exactly Graham's LPT (4/3-approximation [Gr69]); on
    uniform machines it is the standard 2-approximation for Q||C_max.

    ``proc_times=`` lifts the same rule to unrelated processors:
    operations in descending best-case time, placed at
    ``argmin_i (T_i + p[j, i])``. An exactly rank-1 matrix delegates to
    the uniform-machines path above (bit-identical assignments).
    """
    loads = np.asarray(loads, dtype=np.float64)
    _require_one_speed_source(speeds, proc_times)
    p = _proc_or_none(proc_times, loads, num_slots)
    if p is not None:
        rank1 = factor_rank1_proc_times(p)
        if rank1 is not None:
            q_loads, q_speeds = rank1
            inner = schedule_lpt(q_loads, num_slots, speeds=q_speeds)
            return Schedule.from_proc_assignment(
                inner.assignment, loads, p, num_slots)
        return Schedule.from_proc_assignment(_eft_r(p), loads, p, num_slots)
    dead = _dead_slot_split(speeds, num_slots)
    if dead is not None:
        alive, s_alive = dead
        inner = schedule_lpt(loads, alive.size, speeds=s_alive)
        return Schedule.from_assignment(
            alive[inner.assignment], loads, num_slots, speeds=speeds
        )
    s = _speeds_or_ones(speeds, num_slots)
    n = loads.shape[0]
    order = np.argsort(-loads, kind="stable")
    assignment = np.zeros(n, dtype=np.int32)
    # Pure-Python placement: np.argmin on an m-vector pays microseconds of
    # dispatch per call, which dominates the plan path at n >= 1e5 clusters.
    # Python floats are IEEE doubles, so (load + w) / speed rounds exactly as
    # the vectorised expression did — assignments stay bit-identical, with
    # ties still broken toward the lowest slot index.
    slot_loads = [0.0] * num_slots
    sp = [float(v) for v in s]
    w_list = loads.tolist()
    for j in order.tolist():
        w = w_list[j]
        best = 0
        best_key = (slot_loads[0] + w) / sp[0]
        for i in range(1, num_slots):
            key = (slot_loads[i] + w) / sp[i]
            if key < best_key:
                best = i
                best_key = key
        assignment[j] = best
        slot_loads[best] += w
    return Schedule.from_assignment(assignment, loads, num_slots, speeds=speeds)


# ---------------------------------------------------------------------------
# MULTIFIT: binary search on a finish-time deadline with first-fit-decreasing.
# ---------------------------------------------------------------------------


def _ffd_fits(
    loads_desc: np.ndarray,
    num_slots: int,
    deadline: float,
    speeds: np.ndarray,
    slot_order: np.ndarray,
) -> Optional[np.ndarray]:
    """First-fit-decreasing against per-slot capacity ``deadline * speed``.

    Slots are probed fastest-first (``slot_order``); returns the assignment
    (in sorted-operation order) or None when some operation does not fit.
    """
    slot_loads = np.zeros(num_slots)
    caps = deadline * speeds
    assignment = np.empty(loads_desc.shape[0], dtype=np.int32)
    for j, w in enumerate(loads_desc):
        placed = False
        for s in slot_order:
            if slot_loads[s] + w <= caps[s]:
                slot_loads[s] += w
                assignment[j] = s
                placed = True
                break
        if not placed:
            return None
    return assignment


def _ffd_fits_r(
    p_desc: np.ndarray,
    deadline: float,
) -> Optional[np.ndarray]:
    """FFD probe on unrelated processors: fit each op by preferred slot.

    ``p_desc`` is the proc-time matrix with rows already in descending
    best-case order. Each operation probes its *own* slot preference
    (ascending ``p[j, i]``, stable) — there is no global fastest-first
    order when every operation ranks the slots differently — and fits
    where ``T_i + p[j, i] <= deadline``. Returns the assignment in
    sorted-operation order, or None when some operation does not fit.
    """
    n, m = p_desc.shape
    finish = np.zeros(m, dtype=np.float64)
    assignment = np.empty(n, dtype=np.int32)
    pref = np.argsort(p_desc, axis=1, kind="stable")
    for j in range(n):
        placed = False
        for s in pref[j]:
            pj = p_desc[j, s]
            if np.isfinite(pj) and finish[s] + pj <= deadline:
                finish[s] += pj
                assignment[j] = s
                placed = True
                break
        if not placed:
            return None
    return assignment


def schedule_multifit(
    loads: Sequence[float],
    num_slots: int,
    iters: int = 20,
    speeds: Optional[Sequence[float]] = None,
    proc_times: Optional[Sequence[Sequence[float]]] = None,
) -> Schedule:
    """MULTIFIT: binary search on a finish-time deadline with an FFD probe.

    The classic bin-capacity search, lifted to Q||C_max: a probe at
    deadline ``C`` gives slot ``j`` capacity ``C * s_j`` (the load it can
    finish by ``C``). Uniform speeds reduce to the original algorithm.

    ``proc_times=`` lifts it to R||C_max — the deadline becomes a direct
    finish-time budget per slot (``T_i + p[j, i] <= C``), bracketed
    between the classic lower bounds and the EFT-greedy makespan; this
    is the binary-search-over-a-feasibility-LP shape of Fotakis et al.
    (arXiv 1312.4203) with FFD standing in for the rounding step. An
    exactly rank-1 matrix delegates to the uniform-machines path.
    """
    loads = np.asarray(loads, dtype=np.float64)
    _require_one_speed_source(speeds, proc_times)
    p = _proc_or_none(proc_times, loads, num_slots)
    if p is not None:
        rank1 = factor_rank1_proc_times(p)
        if rank1 is not None:
            q_loads, q_speeds = rank1
            inner = schedule_multifit(
                q_loads, num_slots, iters=iters, speeds=q_speeds)
            return Schedule.from_proc_assignment(
                inner.assignment, loads, p, num_slots)
        if p.shape[0] == 0:
            return Schedule.from_proc_assignment(
                np.zeros(0, np.int32), loads, p, num_slots)
        best_case = np.min(p, axis=1)
        order = np.argsort(-best_case, kind="stable")
        p_desc = p[order]
        alive = int((~proc_dead_slots(p)).sum())
        eft = _eft_r(p)
        hi = float(Schedule.from_proc_assignment(
            eft, loads, p, num_slots).makespan)
        lo = float(max(best_case.sum() / max(alive, 1), best_case.max()))
        best = None
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            fit = _ffd_fits_r(p_desc, mid)
            if fit is not None:
                best = fit
                hi = mid
            else:
                lo = mid
        if best is None:
            # The EFT schedule is always feasible at its own makespan.
            assignment = eft
        else:
            assignment = np.empty_like(best)
            assignment[order] = best
        return Schedule.from_proc_assignment(assignment, loads, p, num_slots)
    dead = _dead_slot_split(speeds, num_slots)
    if dead is not None:
        alive, s_alive = dead
        inner = schedule_multifit(loads, alive.size, iters=iters, speeds=s_alive)
        return Schedule.from_assignment(
            alive[inner.assignment], loads, num_slots, speeds=speeds
        )
    s = _speeds_or_ones(speeds, num_slots)
    order = np.argsort(-loads, kind="stable")
    loads_desc = loads[order]
    # Fastest slots first — stable, so uniform speeds keep the 0..m-1 order.
    slot_order = np.argsort(-s, kind="stable")
    total = loads.sum()
    biggest = loads_desc[0] if loads.size else 0.0
    lo = max(total / s.sum(), biggest / s.max())
    hi = max(2 * total / s.sum(), biggest / s.max())
    best = None
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        fit = _ffd_fits(loads_desc, num_slots, mid, s, slot_order)
        if fit is not None:
            best = fit
            hi = mid
        else:
            lo = mid
    if best is None:
        best = _ffd_fits(loads_desc, num_slots, hi, s, slot_order)
        if best is None:  # pragma: no cover - hi is always feasible eventually
            return schedule_lpt(loads, num_slots, speeds=speeds)
    assignment = np.empty_like(best)
    assignment[order] = best
    return Schedule.from_assignment(assignment, loads, num_slots, speeds=speeds)


# ---------------------------------------------------------------------------
# The paper's algorithm: DP decomposition into Balanced Subset Sum.
# ---------------------------------------------------------------------------


def schedule_bss(
    loads: Sequence[float],
    num_slots: int,
    eta: float = 0.002,
    refine: bool = True,
    speeds: Optional[Sequence[float]] = None,
) -> Schedule:
    """Dynamic-programming decomposition over per-slot BSS sub-problems.

    Slots are peeled fastest-first; each slot's balanced target is its
    speed-proportional share ``T_j = remaining_total * s_j / remaining_speed``
    (the finish-balanced split — uniform speeds give the paper's
    ``remaining_total / remaining_slots``, §4.2 / [F+14]) and the
    remaining-operation subset whose load sum is closest to ``T_j`` is
    picked with an ``eta``-FPTAS; the last slot takes the remainder.
    Operations larger than the target get a dedicated slot (they dominate
    the makespan on their own; packing more onto that slot can only hurt).

    ``refine=True`` runs a cheap post-pass: if the makespan slot can donate
    an operation to the earliest-finishing slot and improve, do so
    (repeat). This recovers a little of the FPTAS rounding slack.
    """
    loads = np.asarray(loads, dtype=np.float64)
    dead = _dead_slot_split(speeds, num_slots)
    if dead is not None:
        alive, s_alive = dead
        inner = schedule_bss(
            loads, alive.size, eta=eta, refine=refine, speeds=s_alive
        )
        return Schedule.from_assignment(
            alive[inner.assignment], loads, num_slots, speeds=speeds
        )
    s = _speeds_or_ones(speeds, num_slots)
    n = loads.shape[0]
    assignment = np.full(n, -1, dtype=np.int32)
    if n == 0:
        return Schedule.from_assignment(
            np.zeros(0, np.int32), loads, num_slots, speeds=speeds
        )

    # Fastest slots first (stable → uniform speeds keep slot order 0..m-1):
    # the big subsets should land on the slots that can absorb them.
    slot_order = np.argsort(-s, kind="stable")
    remaining = list(np.argsort(-loads, kind="stable"))  # indices, descending load
    for rank in range(num_slots - 1):
        if not remaining:
            break
        slot = int(slot_order[rank])
        rem_loads = loads[remaining]
        total_rem = float(rem_loads.sum())
        speed_rem = float(s[slot_order[rank:]].sum())
        target = total_rem * float(s[slot]) / speed_rem
        if loads[remaining[0]] >= target and len(remaining) > 1:
            # A single dominating operation: isolate it (paper's huge-key case —
            # e.g. the 1.97e6-pair operation of Fig 1a).
            assignment[remaining.pop(0)] = slot
            continue
        chosen = _bss.bss_approx([float(x) for x in rem_loads], target, eta=eta)
        if not chosen:
            chosen = [0]
        chosen_set = set(chosen)
        for local_idx in sorted(chosen_set, reverse=True):
            assignment[remaining[local_idx]] = slot
        remaining = [g for i, g in enumerate(remaining) if i not in chosen_set]
    last_slot = int(slot_order[num_slots - 1])
    for g in remaining:
        assignment[g] = last_slot

    sched = Schedule.from_assignment(assignment, loads, num_slots, speeds=speeds)
    if refine:
        sched = _refine_moves(sched, loads)
        # The DP decomposition is near-optimal on skewed instances but can
        # lose to plain LPT on tiny/uniform ones; both are cheap host-side,
        # so keep whichever schedule is better (never worse than LPT).
        lpt = schedule_lpt(loads, num_slots, speeds=speeds)
        if lpt.makespan < sched.makespan:
            sched = lpt
    return sched


def _refine_moves(sched: Schedule, loads: np.ndarray, max_moves: int = 256) -> Schedule:
    """Greedy post-pass: donate ops from the makespan slot while it improves.

    Works in finish-time space, so a slow slot sheds work to fast idle
    slots; with uniform speeds this is exactly the load-space pass.
    """
    assignment = sched.assignment.copy()
    slot_loads = sched.slot_loads.copy()
    speeds = sched.slot_speeds
    for _ in range(max_moves):
        finish = slot_loads / speeds
        src = int(finish.argmax())
        dst = int(finish.argmin())
        if src == dst:
            break
        ops = np.nonzero(assignment == src)[0]
        if ops.size <= 1:
            break
        # An op w helps only if the destination stays under the current
        # makespan: (load_dst + w) / s_dst < finish_src.
        headroom = finish[src] * speeds[dst] - slot_loads[dst]
        cand = ops[loads[ops] < headroom]
        if cand.size == 0:
            break
        # Move the largest op that still improves the makespan.
        j = cand[np.argmax(loads[cand])]
        new_src = slot_loads[src] - loads[j]
        new_dst = slot_loads[dst] + loads[j]
        if max(new_src / speeds[src], new_dst / speeds[dst]) >= finish[src]:
            break
        assignment[j] = dst
        slot_loads[src] = new_src
        slot_loads[dst] = new_dst
    return Schedule.from_assignment(
        assignment, loads, sched.num_slots, speeds=sched.slot_speeds
    )


# ---------------------------------------------------------------------------
# Exact solver for tiny instances (test oracle).
# ---------------------------------------------------------------------------


def _brute_r(p: np.ndarray, num_slots: int) -> np.ndarray:
    """Exact R||C_max branch-and-bound over a (n ≤ 14) proc-time matrix.

    Slots are interchangeable only when their entire remaining columns
    match (precomputed column groups) *and* their accumulated finish
    times match — the unrelated-processors analogue of the (load, speed)
    symmetry key. Each node is additionally bounded by the averaged
    best-case remaining work: even if every remaining op ran at its
    fastest slot's time, the final makespan is at least
    ``(Σ finish + Σ remaining best-case) / num_alive``.
    """
    n = p.shape[0]
    alive = max(int((~proc_dead_slots(p)).sum()), 1)
    best_case = np.min(p, axis=1)
    order = np.argsort(-best_case, kind="stable")
    # Suffix sums of best-case times: an admissible completion bound.
    suffix = np.concatenate([np.cumsum(best_case[order][::-1])[::-1], [0.0]])
    # Column symmetry groups: identical columns are interchangeable.
    col_group = np.zeros(num_slots, dtype=np.int64)
    seen_cols: dict = {}
    for k in range(num_slots):
        key = p[:, k].tobytes()
        col_group[k] = seen_cols.setdefault(key, len(seen_cols))
    best_assign = np.zeros(n, dtype=np.int32)
    best_max = float("inf")
    assign = np.zeros(n, dtype=np.int32)
    finish = np.zeros(num_slots, dtype=np.float64)

    def rec(i: int) -> None:
        """Place operation order[i] on every non-symmetric slot, pruned."""
        nonlocal best_max, best_assign
        cur = finish.max()
        if max(cur, (finish.sum() + suffix[i]) / alive) >= best_max:
            return
        if i == n:
            best_max = float(cur)
            best_assign = assign.copy()
            return
        j = order[i]
        seen: set = set()
        for k in range(num_slots):
            pj = p[j, k]
            if not np.isfinite(pj):
                continue  # dead or incompatible slot: never assignable
            key = (round(float(finish[k]), 9), int(col_group[k]))
            if key in seen:
                continue
            seen.add(key)
            finish[k] += pj
            assign[j] = k
            rec(i + 1)
            finish[k] -= pj
    rec(0)
    if not np.isfinite(best_max) and n:  # pragma: no cover - defensive
        return _eft_r(p)
    return best_assign


def schedule_brute(
    loads: Sequence[float],
    num_slots: int,
    speeds: Optional[Sequence[float]] = None,
    proc_times: Optional[Sequence[Sequence[float]]] = None,
) -> Schedule:
    """Exact optimum by symmetry-pruned branch-and-bound (n ≤ 14; test oracle).

    Minimises the *makespan* ``max_j load_j / s_j``; slots are symmetric
    (interchangeable) only when both load and speed match. With
    ``proc_times=`` it minimises ``max_i Σ_j p[j, i]`` exactly — the
    R||C_max oracle the multi-job property suite cross-checks against.
    """
    loads = np.asarray(loads, dtype=np.float64)
    _require_one_speed_source(speeds, proc_times)
    p = _proc_or_none(proc_times, loads, num_slots)
    if p is not None:
        if p.shape[0] > 14:
            raise ValueError("brute force is for tiny test instances only")
        rank1 = factor_rank1_proc_times(p)
        if rank1 is not None:
            q_loads, q_speeds = rank1
            inner = schedule_brute(q_loads, num_slots, speeds=q_speeds)
            return Schedule.from_proc_assignment(
                inner.assignment, loads, p, num_slots)
        return Schedule.from_proc_assignment(
            _brute_r(p, num_slots), loads, p, num_slots)
    dead = _dead_slot_split(speeds, num_slots)
    if dead is not None:
        alive, s_alive = dead
        inner = schedule_brute(loads, alive.size, speeds=s_alive)
        return Schedule.from_assignment(
            alive[inner.assignment], loads, num_slots, speeds=speeds
        )
    s = _speeds_or_ones(speeds, num_slots)
    n = loads.shape[0]
    if n > 14:
        raise ValueError("brute force is for tiny test instances only")
    best_assign = np.zeros(n, dtype=np.int32)
    best_max = float("inf")
    assign = np.zeros(n, dtype=np.int32)
    slot_loads = np.zeros(num_slots)
    order = np.argsort(-loads, kind="stable")

    def rec(i: int) -> None:
        """Place operation order[i] on every non-symmetric slot, pruned."""
        nonlocal best_max, best_assign
        if (slot_loads / s).max() >= best_max:
            return
        if i == n:
            best_max = float((slot_loads / s).max())
            best_assign = assign.copy()
            return
        j = order[i]
        seen: set = set()
        for k in range(num_slots):
            key = (round(slot_loads[k], 9), round(float(s[k]), 9))
            if key in seen:
                continue  # symmetry: equal (load, speed) slots are interchangeable
            seen.add(key)
            slot_loads[k] += loads[j]
            assign[j] = k
            rec(i + 1)
            slot_loads[k] -= loads[j]

    rec(0)
    return Schedule.from_assignment(best_assign, loads, num_slots, speeds=speeds)


# ---------------------------------------------------------------------------
# R||C_max native strategy: EFT-greedy + jump/swap local search.
# ---------------------------------------------------------------------------


def _refine_moves_r(
    assignment: np.ndarray, p: np.ndarray, max_moves: int = 256
) -> np.ndarray:
    """Local search on unrelated processors: jumps off the makespan slot.

    Repeatedly take the slot defining the makespan and try to *jump* one
    of its operations to whichever slot finishes it earliest without
    creating a new, equal-or-worse makespan — the single-exchange
    neighbourhood whose local optima are within 2·OPT + p_max on R
    (the combinatorial half of the Fotakis et al. analysis; the LP
    rounding supplies the other half). Stops at a local optimum.
    """
    assignment = assignment.copy()
    n, m = p.shape
    paid = p[np.arange(n), assignment]
    finish = np.bincount(assignment, weights=paid, minlength=m)[:m]
    for _ in range(max_moves):
        src = int(np.argmax(finish))
        span = finish[src]
        ops = np.flatnonzero(assignment == src)
        moved = False
        # Try the biggest contributors first: moving them buys the most.
        for j in ops[np.argsort(-p[ops, src], kind="stable")]:
            with np.errstate(invalid="ignore"):
                cand = finish + p[j]
            cand[src] = np.inf
            dst = int(np.argmin(cand))
            # The jump must strictly improve the slot pair's worst finish.
            if cand[dst] < span and np.isfinite(cand[dst]):
                finish[src] -= p[j, src]
                finish[dst] += p[j, dst]
                assignment[j] = dst
                moved = True
                break
        if not moved:
            return assignment
    return assignment


def schedule_unrelated(
    loads: Sequence[float],
    num_slots: int,
    speeds: Optional[Sequence[float]] = None,
    proc_times: Optional[Sequence[Sequence[float]]] = None,
) -> Schedule:
    """R||C_max strategy: earliest-finish-time greedy + local search.

    The practical half of Fotakis et al. (arXiv 1312.4203): operations
    in descending best-case time are placed greedily at their earliest
    finishing slot, then a jump local search drains the makespan slot
    until no single move improves. Called without ``proc_times`` it
    embeds the uniform instance (``rank1_proc_times``) first, so it
    degrades gracefully to a Q||C_max / P||C_max heuristic — but its
    reason to exist is the genuinely unrelated matrix, where no speed
    vector can express that different jobs rank the slots differently.
    """
    loads = np.asarray(loads, dtype=np.float64)
    _require_one_speed_source(speeds, proc_times)
    p = _proc_or_none(proc_times, loads, num_slots)
    if p is None:
        p = rank1_proc_times(loads, speeds, num_slots)
    if p.shape[0] == 0:
        return Schedule.from_proc_assignment(
            np.zeros(0, np.int32), loads, p, num_slots)
    assignment = _refine_moves_r(_eft_r(p), p)
    return Schedule.from_proc_assignment(assignment, loads, p, num_slots)


SCHEDULERS: Dict[str, Callable[..., Schedule]] = {
    "hash": schedule_hash,
    "lpt": schedule_lpt,
    "multifit": schedule_multifit,
    "bss": schedule_bss,
    "os4m": schedule_bss,  # alias: the paper's method
    "unrelated": schedule_unrelated,  # R||C_max native (multi-job R-matrix)
}

# The candidate pool "auto" mode chooses from (simulator.pick_strategy):
# every concrete algorithm, cheapest-overhead first so cost ties resolve to
# the cheaper scheduler.
AUTO_CANDIDATES = ("hash", "lpt", "multifit", "bss")


def get_scheduler(name: str) -> Callable[..., Schedule]:
    """Look up a concrete scheduling function by name (see ``SCHEDULERS``)."""
    try:
        return SCHEDULERS[name]
    except KeyError as exc:
        raise ValueError(
            f"unknown scheduler {name!r}; options: {sorted(SCHEDULERS)} "
            "(or 'auto' at the MapReduceConfig level, resolved by "
            "simulator.pick_strategy)"
        ) from exc



# ---------------------------------------------------------------------------
# LPT on the device (the reference's lpt_assign_jax).
# ---------------------------------------------------------------------------


def lpt_assign_torch(loads, num_slots: int, speeds=None, *, device=None):
    """Earliest-finish-time LPT as tensor ops: ``(assignment, slot_loads)``.

    The reference's ``lpt_assign_jax``. ``loads``: ``(n,)``; ``speeds``:
    optional ``(num_slots,)`` relative slot speeds (``None`` = all nominal;
    a speed of exactly 0 is a dead slot, never chosen). Operations are
    placed in ``argsort(-loads, stable=True)`` order, each on the slot whose
    finish time ``(slot_load + w) / speed`` is least (the first such slot).
    ``assignment`` is int32; ``slot_loads`` is in the compute type.

    A tensor input stays on its own device; a numpy array or a list goes to
    ``default_device(device)`` (the current CUDA device unless the caller
    names one). float64 / int64 inputs compute in float32 / int32, and
    integer loads with ``speeds`` in float32, as the reference does with
    JAX's 64-bit types off. Nothing inside waits for the device (no
    ``.item()``, no copy to the host): n placement steps of a few launches
    each, so it suits a few thousand operations.
    """
    import torch

    from repro_torch.device import default_device

    if isinstance(loads, torch.Tensor):
        if device is not None and torch.device(device) != loads.device:
            raise ValueError(
                f"loads lie on {loads.device}; device={device!r} places only "
                "numpy or list loads")
    else:
        loads = torch.as_tensor(np.asarray(loads),
                                device=default_device(device, "lpt_assign_torch"))
    dev = loads.device
    # The reference runs with JAX's 64-bit types off; the port computes in
    # the same types, or its ties break differently.
    x32 = {torch.float64: torch.float32, torch.int64: torch.int32}
    dtype = x32.get(loads.dtype, loads.dtype)
    loads = loads.to(dtype)
    n = loads.shape[0]
    if speeds is None:
        alive = None
        speeds_t = None
    else:
        # Fractional speeds must not truncate against integer loads.
        dtype = torch.promote_types(loads.dtype, torch.float32)
        loads = loads.to(dtype)
        speeds_t = torch.as_tensor(speeds, device=dev).to(dtype)
        alive = speeds_t > 0
        speeds_t = torch.where(alive, speeds_t, torch.ones_like(speeds_t))
    # Stability explicit: equal loads tie-break as the host LPT does.
    order = torch.argsort(-loads, stable=True)
    sorted_loads = loads[order]
    slot_loads = torch.zeros(num_slots, dtype=dtype, device=dev)
    slots_sorted = torch.empty(n, dtype=torch.int64, device=dev)
    for i in range(n):
        w = sorted_loads[i:i + 1]
        finish = slot_loads + w
        if speeds_t is not None:
            finish = (finish / speeds_t).masked_fill_(~alive, float("inf"))
        elif not finish.is_floating_point():
            finish = finish.to(torch.float32)    # (load + w) / 1 in float32
        torch.argmin(finish, dim=0, keepdim=True, out=slots_sorted[i:i + 1])
        slot_loads.index_add_(0, slots_sorted[i:i + 1], w)
    assignment = torch.empty(n, dtype=torch.int32, device=dev).scatter_(
        0, order, slots_sorted.to(torch.int32))
    return assignment, slot_loads
