"""Reduce pipelining (paper §4.4).

A Reduce task's three phases consume three different resources
(copy = network, sort = disk/memory, run = CPU). Default MapReduce runs the
phases *sequentially over the whole task*; OS4M splits the task input at
operation(-cluster) granularity and streams the operations through a
3-stage pipeline, ordered by **increasing load** to minimise the sort/run
delays (the Map→Reduce barrier).

This module is the pure planner/timing model. It is used by:

* ``repro.core.simulator`` — the cluster-level discrete-event model that
  reproduces the paper's Figs 7/8/9/12/13/14/15/16;
* ``repro.core.mapreduce`` — to pick the on-device chunk order for the
  double-buffered shuffle→reduce scan (the TPU analogue: overlap the
  all-to-all "copy" of chunk *i+1* with the segment-reduce "run" of *i*);
* the MoE dispatch path — chunked all-to-all overlapped with expert FFN.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "plan_order",
    "plan_chunks",
    "WavePlan",
    "WaveCheckpoint",
    "plan_waves",
    "coschedule_waves",
    "coschedule_overlap",
    "PhaseTimes",
    "PipelineResult",
    "run_pipelined",
    "run_sequential",
]


def plan_order(loads: Sequence[float], order: str = "increasing") -> np.ndarray:
    """Operation processing order on the pipeline.

    ``increasing`` (paper default, §4.4): the smallest operation primes the
    pipeline fastest, minimising sort/run delay. ``decreasing`` and
    ``arrival`` provided for ablation (benchmarks/fig12_13_delays.py).
    """
    loads = np.asarray(loads, dtype=np.float64)
    if order == "increasing":
        return np.argsort(loads, kind="stable")
    if order == "decreasing":
        return np.argsort(-loads, kind="stable")
    if order == "arrival":
        return np.arange(loads.shape[0])
    raise ValueError(f"unknown order {order!r}")


def plan_chunks(
    loads: Sequence[float], num_chunks: int, order: str = "increasing"
) -> List[np.ndarray]:
    """Group ordered operations into ``num_chunks`` contiguous chunks.

    Greedy: walk the ordered operations, cut when the running chunk load
    exceeds ``total / num_chunks``. Every chunk is non-empty as long as
    ``len(loads) >= num_chunks``. Used to bound the number of pipeline
    stages (= scan length) on device.
    """
    loads = np.asarray(loads, dtype=np.float64)
    idx = plan_order(loads, order)
    n = idx.shape[0]
    num_chunks = max(1, min(num_chunks, n))
    target = loads.sum() / num_chunks
    ordered = loads[idx]
    # Vectorized greedy walk: within one chunk the running load is the
    # left-to-right prefix sum of the remaining ordered loads (np.cumsum
    # adds in the same sequential order, so cut points land exactly
    # where the element-at-a-time loop put them), and the first position
    # reaching ``target`` is a searchsorted on that monotone prefix
    # (loads are non-negative counts). A cut is only taken while enough
    # operations remain to give every later chunk at least one; once the
    # first qualifying position violates that, no later position can
    # satisfy it either (ops only shrink), so the remainder is the final
    # chunk — again exactly the loop's behaviour.
    chunks: List[np.ndarray] = []
    start = 0
    while len(chunks) < num_chunks - 1 and start < n:
        prefix = np.cumsum(ordered[start:])
        cut = start + int(np.searchsorted(prefix, target, side="left"))
        remaining_slots = num_chunks - len(chunks) - 1
        if cut >= n or n - (cut + 1) < remaining_slots:
            break
        chunks.append(idx[start:cut + 1].astype(np.int64))
        start = cut + 1
    if start < n:
        chunks.append(idx[start:].astype(np.int64))
    return chunks


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """The engine's serialized §4.4 wave plan for one schedule.

    ``rank_of_cluster[j]`` — position of cluster ``j`` in the global
    increasing-load processing order (the one key that is monotone along
    the fused kernel's sorted stream).
    ``chunk_of_cluster[j]`` — which of the ``num_chunks`` waves cluster
    ``j`` travels in; chunk ``c`` is the union of every Reduce slot's
    c-th wave, so every all-to-all stays balanced across destinations.

    Invariants: chunk ids are dense in ``[0, num_chunks)``; each cluster
    appears in exactly one chunk; within a slot, waves are non-decreasing
    in per-wave load. The plan is pure host data (int32 numpy), cheap to
    snapshot in a :class:`repro.core.schedule_cache.CachedSchedule` and
    replay across batches without re-running ``plan_chunks``. The
    structural invariants (permutation rank, dense one-shot chunk ids,
    valid replication pairing) are certified statically by
    ``repro.analysis --check plan`` (see docs/ANALYSIS.md) on every real
    planner output, so an executor never has to re-derive them.
    """

    rank_of_cluster: np.ndarray   # (n,) int32
    chunk_of_cluster: np.ndarray  # (n,) int32
    num_chunks: int
    # Coded-shuffle replication factor r (Coded MapReduce, arXiv
    # 1512.01625): r = 1 is the plain unicast shuffle; r = 2 means map
    # shards are pair-replicated and phase B ships XOR multicast packets
    # (``kernels/coded_shuffle``) instead of per-destination slabs. The
    # factor lives on the wave plan — not just the config — so a cached
    # snapshot replays with the wire format it was planned for.
    replication: int = 1

    def chunk_members(self, c: int) -> np.ndarray:
        """Cluster ids travelling in wave ``c``."""
        return np.nonzero(self.chunk_of_cluster == c)[0]

    def to_json(self) -> Dict[str, Any]:
        """Plain-type form for persistence alongside the cached schedule."""
        return {
            "rank_of_cluster": self.rank_of_cluster.tolist(),
            "chunk_of_cluster": self.chunk_of_cluster.tolist(),
            "num_chunks": int(self.num_chunks),
            "replication": int(self.replication),
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "WavePlan":
        """Rebuild a plan from :meth:`to_json` output (pre-coded snapshots
        default to replication=1)."""
        return WavePlan(
            rank_of_cluster=np.asarray(d["rank_of_cluster"], np.int32),
            chunk_of_cluster=np.asarray(d["chunk_of_cluster"], np.int32),
            num_chunks=int(d["num_chunks"]),
            replication=int(d.get("replication", 1)),
        )


@dataclasses.dataclass
class WaveCheckpoint:
    """Phase-B progress persisted at wave granularity (elastic mesh).

    Written by the checkpointing executor after each completed wave:
    waves ``[0, wave_cursor)`` of the plan's ``num_chunks`` are done and
    their per-cluster reduce outputs are final (every cluster travels in
    exactly one wave, so a completed wave's clusters never change again).
    On a mid-batch slot failure only the waves *at or after* the cursor
    are replanned onto the surviving mesh and re-executed — the replay
    bound the elastic CI gate asserts (``replayed ≤ num_chunks −
    wave_cursor``).

    ``completed_clusters`` is the boolean union of the finished waves'
    memberships; ``outputs`` maps cluster id → its final merged ``(v,)``
    reduce output (host numpy — a checkpoint must survive the device that
    produced it).
    """

    num_chunks: int
    wave_cursor: int = 0
    completed_clusters: Optional[np.ndarray] = None   # (n,) bool
    outputs: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    def mark_wave(self, members: np.ndarray, outputs: Dict[int, np.ndarray],
                  num_clusters: int) -> None:
        """Record one finished wave: advance the cursor, absorb its outputs."""
        if self.completed_clusters is None:
            self.completed_clusters = np.zeros(num_clusters, dtype=bool)
        self.completed_clusters[np.asarray(members, np.int64)] = True
        self.outputs.update(outputs)
        self.wave_cursor += 1

    @property
    def remaining_waves(self) -> int:
        """Waves that would need replay after a failure right now."""
        return max(0, self.num_chunks - self.wave_cursor)


# Warn-once flag for the chunks > clusters degenerate guard below.
_warned_excess_chunks = False


def plan_waves(
    loads: Sequence[float],
    assignment: np.ndarray,
    num_slots: int,
    num_chunks: int,
    order: str = "increasing",
    speeds: Optional[Sequence[float]] = None,
    replication: int = 1,
    pinned_first: Optional[Sequence[int]] = None,
) -> WavePlan:
    """Cut a schedule into per-slot §4.4 waves and merge them into chunks.

    The paper pipelines *within each Reduce task*: a slot streams its own
    operations in increasing-load order. Each slot's operations are cut
    into ``num_chunks`` load-balanced runs (:func:`plan_chunks`); wave
    ``c`` of the job is the union of every slot's c-th run, so per-wave
    loads are ≈ ``slot_load / num_chunks`` on every destination at once
    and the statistics-sized chunk buffers sum to ≈ the sequential buffer
    instead of C× it. Empty waves (tiny jobs) are dropped and chunk ids
    renumbered densely.

    ``speeds`` (Q||C_max): the *global* rank order balances waves by
    **finish time** — a cluster's pipeline priority is ``load /
    speed(assigned slot)``, so a modest cluster on a straggler slot is
    sequenced like the long-running operation it actually is. Within one
    slot the speed is constant, so the per-slot wave cutting (and hence
    the chunk membership invariants) are unchanged; uniform speeds
    reproduce the load-ordered plan bit-identically.

    ``replication`` is carried onto the plan as coded-shuffle metadata
    (:class:`WavePlan` ``replication``); it does not change wave cutting
    — coding changes the wire format of each wave's all-to-all, not
    which clusters travel together.

    Degenerate inputs with ``num_chunks > n`` (more pipeline stages than
    operation clusters) are clamped to ``n`` with a one-time warning:
    the extra stages could only ever be empty trailing waves, which
    would waste all-to-all dispatches on zero-row slabs.

    ``pinned_first`` (streaming-prefix planning): clusters listed here
    are forced into chunk 0 regardless of their load, and every
    remaining cluster is cut into the ``num_chunks - 1`` later waves.
    This is how a prefix-planned wave 1 keeps its committed membership
    when the plan is refined on the full statistics — wave 1 may already
    be in flight, so the refinement can only re-cut the tail. With a
    pin, the within-slot increasing-load invariant holds among waves
    ``1..C-1`` but not necessarily between chunk 0 and the rest.
    ``num_chunks == 1`` degenerates correctly (everything is chunk 0).
    """
    global _warned_excess_chunks
    loads = np.asarray(loads, dtype=np.float64)
    assignment = np.asarray(assignment)
    n = loads.shape[0]
    if num_chunks > n > 0:
        if not _warned_excess_chunks:
            _warned_excess_chunks = True
            warnings.warn(
                f"plan_waves: num_chunks={num_chunks} exceeds the "
                f"{n} operation cluster(s); clamping to {n} — the extra "
                "chunks would only produce empty trailing waves",
                stacklevel=2,
            )
        num_chunks = n
    if speeds is not None:
        speeds = np.asarray(speeds, np.float64)
        slot_speed = speeds[np.clip(assignment, 0, num_slots - 1)]
        # Dead slots (exact speed 0, elastic mesh) never receive
        # assignments from the schedulers; if an assignment does point at
        # one, rank it as nominal rather than emitting inf finish costs.
        finish_costs = loads / np.where(slot_speed > 0, slot_speed, 1.0)
        global_order = plan_order(finish_costs, order)
    else:
        global_order = plan_order(loads, order)
    rank_of_cluster = np.empty(n, np.int32)
    rank_of_cluster[global_order] = np.arange(n, dtype=np.int32)
    chunk_of_cluster = np.zeros(n, np.int32)
    n_waves = max(1, min(num_chunks, n))
    pinned = np.zeros(n, dtype=bool)
    if pinned_first is not None and n:
        pinned[np.asarray(list(pinned_first), np.int64)] = True
    for d in range(num_slots):
        members_d = np.nonzero((assignment == d) & ~pinned)[0]
        if members_d.size == 0:
            continue
        if pinned.any():
            # Pinned clusters already occupy chunk 0; the rest of this
            # slot fills the later waves (shifted by one). A 1-wave plan
            # leaves everything in chunk 0.
            rest_waves = plan_chunks(loads[members_d], max(1, n_waves - 1),
                                     order)
            for ci, wave in enumerate(rest_waves):
                shifted = min(ci + 1, n_waves - 1)
                chunk_of_cluster[members_d[wave]] = shifted
        else:
            waves = plan_chunks(loads[members_d], n_waves, order)
            for ci, wave in enumerate(waves):
                chunk_of_cluster[members_d[wave]] = min(ci, n_waves - 1)
    used = np.unique(chunk_of_cluster[:n] if n else [])
    if n:
        remap = {int(c): i for i, c in enumerate(sorted(used))}
        chunk_of_cluster = np.asarray(
            [remap[int(c)] for c in chunk_of_cluster], np.int32
        )
    return WavePlan(
        rank_of_cluster=rank_of_cluster,
        chunk_of_cluster=chunk_of_cluster,
        num_chunks=max(1, len(used)),
        replication=int(replication),
    )


@dataclasses.dataclass(frozen=True)
class PhaseTimes:
    """Per-operation durations of each phase, seconds."""

    copy: np.ndarray
    sort: np.ndarray
    run: np.ndarray

    def __post_init__(self):
        for f in (self.copy, self.sort, self.run):
            if np.any(np.asarray(f) < 0):
                raise ValueError("phase durations must be non-negative")


@dataclasses.dataclass(frozen=True)
class PipelineResult:
    """Timing summary of one Reduce task's copy/sort/run execution."""

    finish_time: float       # relative to pipeline start (all Maps done)
    sort_delay: float        # first op enters sort  (paper Fig 12)
    run_delay: float         # first op enters run   (paper Fig 13)
    copy_busy: float
    sort_busy: float
    run_busy: float

    @property
    def resource_utilisation(self) -> float:
        """Mean busy fraction of the three resources over the task's span."""
        if self.finish_time == 0:
            return 1.0
        return (self.copy_busy + self.sort_busy + self.run_busy) / (3 * self.finish_time)


def run_pipelined(
    phases: PhaseTimes, order: Sequence[int] | None = None, start: float = 0.0
) -> PipelineResult:
    """3-stage flow-shop timing: each resource handles one operation at a time.

    ``copy_i`` starts when the network is free; ``sort_i`` when both
    ``copy_i`` is done and the sorter is free; ``run_i`` likewise. This is
    the OS4M Reduce task of Fig 4(b).
    """
    copy, sort, run = (np.asarray(p, dtype=np.float64) for p in (phases.copy, phases.sort, phases.run))
    n = copy.shape[0]
    if order is None:
        order = np.arange(n)
    t_copy = t_sort = t_run = start
    first_sort = first_run = None
    for j in order:
        c_end = t_copy + copy[j]
        t_copy = c_end
        s_start = max(c_end, t_sort)
        if first_sort is None:
            first_sort = s_start
        s_end = s_start + sort[j]
        t_sort = s_end
        r_start = max(s_end, t_run)
        if first_run is None:
            first_run = r_start
        t_run = r_start + run[j]
    return PipelineResult(
        finish_time=t_run - start,
        sort_delay=(first_sort - start) if first_sort is not None else 0.0,
        run_delay=(first_run - start) if first_run is not None else 0.0,
        copy_busy=float(copy.sum()),
        sort_busy=float(sort.sum()),
        run_busy=float(run.sum()),
    )


def run_sequential(
    phases: PhaseTimes,
    start: float = 0.0,
    copy_head_start: float = 0.0,
    whole_task_sort: float | None = None,
) -> PipelineResult:
    """Default MapReduce Reduce task (Fig 4a): copy ALL, then sort ALL, then run ALL.

    ``copy_head_start``: how much copy work Hadoop already finished before
    the pipeline clock starts (it overlaps the copy phase with Map tasks).
    ``whole_task_sort``: Hadoop sorts the *entire* input in one (possibly
    multi-pass, disk-bound) sort; if given, it replaces ``sum(phases.sort)``.
    """
    copy, sort, run = (np.asarray(p, dtype=np.float64) for p in (phases.copy, phases.sort, phases.run))
    copy_total = max(0.0, float(copy.sum()) - copy_head_start)
    sort_total = float(sort.sum()) if whole_task_sort is None else whole_task_sort
    run_total = float(run.sum())
    sort_start = start + copy_total
    run_start = sort_start + sort_total
    return PipelineResult(
        finish_time=copy_total + sort_total + run_total,
        sort_delay=sort_start - start,
        run_delay=run_start - start,
        copy_busy=copy_total,
        sort_busy=sort_total,
        run_busy=run_total,
    )


# ---------------------------------------------------------------------------
# Multi-job co-scheduling: interleave several jobs' wave plans on one mesh.
# ---------------------------------------------------------------------------


def coschedule_waves(
    plans: Sequence["WavePlan"],
) -> List[tuple]:
    """Interleave N jobs' §4.4 wave sequences into one issue order.

    Returns ``[(job_index, wave_index), ...]`` — a round-robin merge that
    keeps each job's waves in order while alternating jobs whenever more
    than one still has waves left. Consecutive entries from *different*
    jobs are the co-scheduling win: wave ``w+1`` of one job is
    double-buffered (its all-to-all copy issued) while the *other* job's
    wave computes, so job B's a2a hides under job A's reduce exactly the
    way a single job's next wave hides under its current one
    (:func:`run_pipelined`) — but now the overlap survives each job's
    phase boundaries. Jobs with more waves than the rest finish with a
    consecutive (non-overlapped) tail, which
    :func:`coschedule_overlap` makes visible.
    """
    cursors = [0] * len(plans)
    totals = [int(p.num_chunks) for p in plans]
    out: List[tuple] = []
    live = [j for j, t in enumerate(totals) if t > 0]
    turn = 0
    while live:
        # Rotate through the live jobs so no job's waves starve.
        job = live[turn % len(live)]
        out.append((job, cursors[job]))
        cursors[job] += 1
        if cursors[job] >= totals[job]:
            drop = live.index(job)
            live.pop(drop)
            turn = drop  # next job after the one that just finished
        else:
            turn += 1
    return out


def coschedule_overlap(issue_order: Sequence[tuple]) -> float:
    """Fraction of wave transitions that cross jobs (overlap opportunities).

    Each adjacent pair from different jobs means the later wave's
    all-to-all was issued while another job's wave computed — the
    cross-job analogue of the double-buffer overlap inside one job. 0.0
    for FIFO one-job-at-a-time (all transitions stay within a job until
    it drains); approaches 1.0 for balanced round-robin co-scheduling.
    """
    if len(issue_order) < 2:
        return 0.0
    crossings = sum(
        1 for a, b in zip(issue_order, issue_order[1:]) if a[0] != b[0])
    return crossings / (len(issue_order) - 1)
