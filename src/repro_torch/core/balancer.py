"""OS4M expert-placement balancer — the paper's scheduler driving MoE EP.

Mapping (DESIGN.md §2.1): routed experts are Reduce *operation clusters*
(all tokens of one expert ↔ all pairs of one key), EP shards are Reduce
*slots*, and the per-expert token histogram psum'd over the mesh is the
§4.1 communication mechanism. The JobTracker step is here: given the
collected key distribution, solve the placement and broadcast it.

Static shapes add one constraint the paper didn't have: every shard
must own exactly ``experts_per_shard`` experts (the expert-weight array is
sharded in equal blocks), so the problem is Q||C_max with a cardinality
constraint: EP shard ``j`` has a relative speed ``s_j`` (mixed device
generations, a throttling host) and the makespan is measured in *finish
time* ``load_j / s_j``. :func:`schedule_balanced_cardinality` solves it
with capacity-constrained earliest-finish-time LPT + pairwise-swap
refinement in finish space; ``speeds=None`` reproduces the P||C_max
placements bit-for-bit. Speeds come from the same measured
:mod:`repro_torch.core.slot_speeds` vector the MapReduce engine estimates.

``ExpertBalancer`` is the stateful driver: accumulate counts (EMA),
replan every ``interval`` steps, emit both the placement table and the
weight-row permutation (moving an operation to another slot physically
moves its weights, :func:`permute_expert_weights` — the analogue of the
paper's schedule broadcast; placement changes never change shapes).

A numpy copy of the reference's balancer (the port imports nothing of
``repro``); only :func:`permute_expert_weights` works on torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.schedule_cache import drift_metric

__all__ = [
    "schedule_balanced_cardinality", "placement_from_assignment",
    "ExpertBalancer", "BalanceReport", "permute_expert_weights",
]


def schedule_balanced_cardinality(
    loads: np.ndarray, num_slots: int, per_slot: int,
    refine_iters: int = 512,
    speeds: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Assign n = num_slots*per_slot operations, exactly per_slot each.

    Greedy earliest-finish-time LPT respecting slot capacity, then
    best-swap refinement in *finish space* (swapping two operations
    between the latest-finishing slot and any other preserves cardinality
    while reducing the makespan ``max_j load_j / s_j``).

    ``speeds`` (Q||C_max): per-slot relative speeds, 1.0 = nominal.
    ``None`` keeps the speed-oblivious greedy key (``argmin`` of held
    load) so existing P||C_max placements are reproduced **bit-for-bit**;
    the finish-space refinement with nominal speeds divides by exactly
    1.0, which is the identity in IEEE arithmetic.

    **Dead slots** (speed exactly 0.0, elastic mesh): the cardinality
    constraint is physical — the expert-weight array is sharded in equal
    blocks, so even a dead shard must *hold* ``per_slot`` expert rows —
    but its experts should carry as little routed load as possible. A
    dead slot therefore participates with an effectively-infinitesimal
    speed: EFT defers it until capacity forces placements there, and the
    swap refinement then drains the heaviest loads off it, so it ends up
    holding the ``per_slot`` lightest experts.
    """
    loads = np.asarray(loads, dtype=np.float64)
    n = loads.shape[0]
    assert n == num_slots * per_slot, (n, num_slots, per_slot)
    sp = np.ones(num_slots) if speeds is None else np.asarray(speeds, np.float64)
    if sp.shape != (num_slots,) or np.any(~np.isfinite(sp)) or np.any(sp < 0):
        raise ValueError(
            f"speeds must be ({num_slots},) finite >= 0 (0 = dead), got {sp}")
    if np.any(sp == 0.0):
        if not np.any(sp > 0):
            raise ValueError("all slots dead: at least one speed must be > 0")
        # Tiny-but-positive effective speed keeps the finish-space math
        # finite while making dead slots maximally unattractive.
        sp = np.where(sp > 0, sp, sp[sp > 0].min() * 1e-9)
    order = np.argsort(-loads, kind="stable")
    assignment = np.empty(n, dtype=np.int32)
    slot_loads = np.zeros(num_slots)
    slot_counts = np.zeros(num_slots, dtype=np.int64)
    for j in order:
        open_slots = np.nonzero(slot_counts < per_slot)[0]
        if speeds is None:
            # P||C_max key, kept verbatim: argmin over held load (ties and
            # rounding identical to the pre-Q code, golden-pinned).
            s = open_slots[np.argmin(slot_loads[open_slots])]
        else:
            # Earliest finish time: where would this operation complete
            # soonest at the slots' relative speeds?
            s = open_slots[np.argmin(
                (slot_loads[open_slots] + loads[j]) / sp[open_slots])]
        assignment[j] = s
        slot_loads[s] += loads[j]
        slot_counts[s] += 1

    # Pairwise swap refinement in finish space: swap one operation of the
    # latest-finishing slot with one of another slot (cardinality
    # preserved); pick the swap that minimises the new pairwise max finish.
    # Repeat until no improving swap. With nominal speeds every division
    # is by 1.0, so this is exactly the load-space pass.
    for _ in range(refine_iters):
        finish = slot_loads / sp
        src = int(finish.argmax())
        cur_max = finish[src]
        src_ops = np.nonzero(assignment == src)[0]
        best = None  # (new_pair_max, a, b, dst)
        for dst in range(num_slots):
            if dst == src:
                continue
            dst_ops = np.nonzero(assignment == dst)[0]
            # delta[a, b] = loads[a] - loads[b]
            delta = loads[src_ops][:, None] - loads[dst_ops][None, :]
            new_src = (slot_loads[src] - delta) / sp[src]
            new_dst = (slot_loads[dst] + delta) / sp[dst]
            pair_max = np.maximum(new_src, new_dst)
            i, jx = np.unravel_index(np.argmin(pair_max), pair_max.shape)
            if pair_max[i, jx] < cur_max - 1e-12:
                if best is None or pair_max[i, jx] < best[0]:
                    best = (pair_max[i, jx], src_ops[i], dst_ops[jx], dst)
        if best is None:
            break
        _, a, b, dst = best
        assignment[a], assignment[b] = dst, src
        slot_loads[src] += loads[b] - loads[a]
        slot_loads[dst] += loads[a] - loads[b]
    return assignment


def placement_from_assignment(assignment: np.ndarray, num_slots: int):
    """assignment (E,) shard-per-expert -> (placement (2, E), perm (E,)).

    ``perm`` lists experts in physical weight order (shard-major, slot
    order within shard): new weight row g holds expert ``perm[g]``.
    """
    e = np.asarray(assignment)
    n = e.shape[0]
    placement = np.zeros((2, n), dtype=np.int32)
    perm = np.zeros(n, dtype=np.int64)
    g = 0
    for s in range(num_slots):
        members = np.nonzero(e == s)[0]
        for slot, ex in enumerate(members):
            placement[0, ex] = s
            placement[1, ex] = slot
            perm[g] = ex
            g += 1
    return placement, perm


@dataclasses.dataclass
class BalanceReport:
    """Per-layer outcome of one replan (loads vs the contiguous baseline).

    Load-space fields are the paper's P||C_max view; ``makespan`` /
    ``finish_ratio`` are the Q||C_max view under the balancer's speed
    vector (``max_j load_j / s_j``; with nominal speeds they equal
    ``max_load`` / ``balance_ratio`` exactly).
    """

    max_load: float
    ideal_load: float
    balance_ratio: float
    baseline_ratio: float           # contiguous/hash-class placement
    moved_experts: int
    makespan: float = 0.0           # finish time of the slowest shard
    finish_ratio: float = 1.0       # makespan / ideal finish (Σload / Σspeed)


class ExpertBalancer:
    """Stateful OS4M replanner for one MoE model (per-layer placements).

    ``max_drift`` (optional) drift-gates the replan the same way
    :class:`repro_torch.core.schedule_cache.ReusePolicy` gates the MapReduce
    engine: at each interval, a layer whose expert-count distribution
    moved less than ``max_drift`` (L1/total-variation,
    :func:`repro_torch.core.schedule_cache.drift_metric`) keeps its current
    placement — no Q||C_max solve, no weight permutation. Steady routing
    then amortizes one placement over many intervals; ``layers_reused``
    counts the skips.

    ``speeds`` (optional) is the per-EP-shard relative speed vector the
    placements are solved under — the same measured ``slot_speeds``
    vector the MapReduce engine estimates. ``None`` ≡ identical shards
    (P||C_max, bit-for-bit the pre-Q placements). Update it mid-training
    with :meth:`set_speeds`; changed speeds count as drift, so the next
    interval re-solves every layer instead of reusing stale placements.
    """

    def __init__(self, num_experts: int, num_slots: int, n_layers: int,
                 interval: int = 100, ema: float = 0.8,
                 max_drift: float | None = None,
                 speeds: Optional[Sequence[float]] = None):
        self.num_experts = num_experts
        self.num_slots = num_slots
        self.per_slot = num_experts // num_slots
        self.n_layers = n_layers
        self.interval = interval
        self.ema = ema
        self.max_drift = max_drift
        self.speeds: Optional[np.ndarray] = None
        self.set_speeds(speeds)
        self.counts = np.zeros((n_layers, num_experts))
        self.step = 0
        # physical order: perm[layer, g] = expert id stored at weight row g
        self.perms = np.tile(np.arange(num_experts), (n_layers, 1))
        self.placements = np.stack(
            [placement_from_assignment(
                np.arange(num_experts) // self.per_slot, num_slots)[0]
             for _ in range(n_layers)])
        # drift baseline: counts each layer's live placement was solved from
        self._planned_counts = np.zeros((n_layers, num_experts))
        self._assignments = np.tile(
            np.arange(num_experts) // self.per_slot, (n_layers, 1))
        self.layers_reused = 0
        self.layers_replanned = 0

    def set_speeds(self, speeds: Optional[Sequence[float]]) -> None:
        """Install a new per-shard speed vector (None ≡ all nominal).

        A *changed* vector invalidates the drift baselines, so the next
        :meth:`replan` re-solves every layer under the new speeds instead
        of drift-gating against placements built for the old ones.
        """
        new = None
        if speeds is not None:
            new = np.asarray(speeds, np.float64)
            if new.shape != (self.num_slots,) or np.any(~np.isfinite(new)) \
                    or np.any(new < 0):
                raise ValueError(
                    f"speeds must be ({self.num_slots},) finite >= 0 "
                    "(0 = dead shard)")
            if not np.any(new > 0):
                raise ValueError(
                    "all shards dead: at least one speed must be > 0")
        old = self.speeds
        changed = ((old is None) != (new is None)
                   or (old is not None and not np.array_equal(old, new)))
        self.speeds = new
        if changed and hasattr(self, "_planned_counts"):
            self._planned_counts[:] = 0.0   # force re-solve at next interval

    def observe(self, counts) -> None:
        """counts (L, E) from the step metrics (the §4.1 statistics)."""
        c = np.asarray(counts, dtype=np.float64)
        self.counts = self.ema * self.counts + (1 - self.ema) * c
        self.step += 1

    def should_replan(self) -> bool:
        """True on interval boundaries (drift gating happens per layer in replan)."""
        return self.step > 0 and self.step % self.interval == 0

    def replan(self) -> Tuple[np.ndarray, List[np.ndarray], List[BalanceReport]]:
        """Returns (placements (L, 2, E), per-layer weight perms, reports).

        With ``max_drift`` set, a layer whose routing distribution stayed
        within the threshold of its plan-time baseline reuses its current
        assignment (the report row is computed against fresh loads, so
        imbalance is still observable); only drifted layers re-solve.
        """
        placements = []
        perms = []
        reports = []
        for layer in range(self.n_layers):
            loads = self.counts[layer]
            reuse = False
            if self.max_drift is not None and self._planned_counts[layer].sum() > 0:
                drift = float(drift_metric(
                    self._planned_counts[layer], loads, "l1"))
                reuse = drift <= self.max_drift
            if reuse:
                self.layers_reused += 1
                assignment = self._assignments[layer]
                # Copies, not views: callers hold the returned perm as the
                # "previous physical order" across intervals, and a later
                # replan writes self.perms[layer] in place.
                placement = self.placements[layer].copy()
                perm = self.perms[layer].copy()
            else:
                self.layers_replanned += 1
                assignment = schedule_balanced_cardinality(
                    loads, self.num_slots, self.per_slot, speeds=self.speeds)
                placement, perm = placement_from_assignment(
                    assignment, self.num_slots)
                self._assignments[layer] = assignment
                self._planned_counts[layer] = loads
                self.placements[layer] = placement
            base = np.arange(self.num_experts) // self.per_slot
            base_loads = np.bincount(base, weights=loads,
                                     minlength=self.num_slots)
            new_loads = np.bincount(assignment, weights=loads,
                                    minlength=self.num_slots)
            ideal = loads.sum() / self.num_slots
            sp = np.ones(self.num_slots) if self.speeds is None else self.speeds
            # Dead shards (speed 0): report finish over surviving shards
            # only — a dead shard's held experts receive ~no routed load
            # by construction, and 0/0 would only produce warning noise.
            with np.errstate(divide="ignore", invalid="ignore"):
                finish = np.where(sp > 0, new_loads / np.where(sp > 0, sp, 1.0),
                                  0.0)
            makespan = float(finish.max())
            ideal_finish = float(loads.sum() / sp.sum())
            reports.append(BalanceReport(
                max_load=float(new_loads.max()),
                ideal_load=float(ideal),
                balance_ratio=float(new_loads.max() / max(ideal, 1e-9)),
                baseline_ratio=float(base_loads.max() / max(ideal, 1e-9)),
                moved_experts=int((perm != self.perms[layer]).sum()),
                makespan=makespan,
                finish_ratio=float(makespan / max(ideal_finish, 1e-9)),
            ))
            placements.append(placement)
            perms.append(perm)
            self.perms[layer] = perm
        return np.stack(placements), perms, reports


def permute_expert_weights(moe, perm, prev_perm=None) -> None:
    """Reorder the stacked expert-weight rows of an MoE module in place.

    ``moe`` holds ``(E, ...)`` ``up`` / ``gate`` / ``down`` weights
    (:class:`repro_torch.nn.moe.MoE`). ``perm[g]`` = expert id that must
    live at physical row g. ``prev_perm`` is the current physical order
    (defaults to identity).
    """
    perm = np.asarray(perm)
    if prev_perm is not None:
        # rows currently hold prev_perm[g]; build index mapping new->current
        cur_pos = np.argsort(prev_perm)      # expert -> current row
        take = cur_pos[perm]
    else:
        take = perm
    with torch.no_grad():
        for name in ("up", "gate", "down"):
            w = getattr(moe, name, None)
            if w is not None:
                w.copy_(w.index_select(0, torch.as_tensor(take, device=w.device)))
