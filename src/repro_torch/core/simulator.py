"""Schedule cost model of a Hadoop-class cluster: the ``auto`` strategy picker.

The reference's module also reproduces the paper's job-duration figures
(``simulate_job`` and its PUMA calibration). The port carries only what
its engines call: ``scheduler="auto"`` (:func:`pick_strategy`) and the
reuse cost gate (:func:`estimate_replan_benefit`), both built on
:func:`estimate_reduce_time` and :func:`scheduling_overhead`, and the
serving engine's and the multi-job coordinator's admission order
(:func:`wspt_order`, :func:`weighted_completion_time`).

The model is the paper's cluster (§5): 8 worker VMs with measured
bandwidths (network 37 MB/s, disk read 203 MB/s, disk write 121 MB/s) and
4 Reduce slots per node. Each candidate schedule's Reduce phase is played
through the copy→sort→run flow shop of :mod:`repro_torch.core.pipeline`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import pipeline as pipe
from repro_torch.core import scheduler as sched_lib

__all__ = [
    "ClusterSpec",
    "PAPER_CLUSTER",
    "estimate_reduce_time",
    "scheduling_overhead",
    "pick_strategy",
    "estimate_replan_benefit",
    "wspt_order",
    "weighted_completion_time",
]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Per-node rates of the paper's cluster (§5) that the cost model reads.

    The reference's ``ClusterSpec`` also carries the Map-side and
    contention knobs of its job simulator, which the port does not carry.
    """

    reduce_slots_per_node: int = 4
    net_bw: float = 37e6          # B/s per node (measured, paper §5)
    disk_read_bw: float = 203e6   # B/s per node


PAPER_CLUSTER = ClusterSpec()


# ---------------------------------------------------------------------------
# Schedule cost model — the "auto" strategy picker.
#
# ``MapReduceConfig(scheduler="auto")`` needs a per-job answer to "which
# P||C_max algorithm is worth its host-side cost for THIS key
# distribution?". The estimate reuses exactly the machinery behind the
# paper figures: each candidate schedule's Reduce phase is played through
# the 3-stage flow-shop model (``pipeline.run_pipelined``) on the paper's
# cluster rates, and a deterministic model of the scheduler's own host
# cost is added so near-identical makespans resolve to the cheaper
# algorithm (on near-uniform distributions hash ≈ BSS on makespan, and
# the FPTAS buys nothing).
# ---------------------------------------------------------------------------


def estimate_reduce_time(
    loads: np.ndarray,
    schedule: sched_lib.Schedule,
    *,
    cluster: ClusterSpec = PAPER_CLUSTER,
    bytes_per_pair: float = 64,
    reduce_cpu_pps: float = 1.7e4,
    pipelined: bool = True,
    pipeline_order: str = "increasing",
    speeds: Optional[np.ndarray] = None,
    local_hist: Optional[np.ndarray] = None,
) -> float:
    """Estimated Reduce-phase makespan (s) of one schedule.

    Per slot: per-cluster copy/sort/run durations from the cluster's
    bandwidth shares, composed with the flow-shop pipeline (or the
    sequential Fig 4(a) layout when ``pipelined=False``); the job finishes
    when the slowest slot does.

    ``speeds`` (Q||C_max): per-slot relative speed factors. A slot at
    speed ``s`` runs *every* phase ``1/s`` slower — a straggler node's
    NIC share, disk, and CPU are all degraded together (noisy neighbour /
    older generation). ``None`` falls back to the schedule's own recorded
    speeds (nominal when those are unset).

    ``local_hist`` — the per-shard ``(m, n)`` K^(i) histogram of §4.1.
    When given, the copy phase charges each slot only for the pairs that
    actually cross the wire to it (``loads[k] − local_hist[slot, k]`` for
    its clusters ``k`` — the slot's own shard of a cluster never leaves
    the node), instead of assuming every pair pays uniform network cost.
    ``bytes_per_pair`` may be a *measured* wire rate (e.g.
    ``JobResult.shuffle_bytes / shuffle_rows`` from the engine's
    accounting layer), which is how quantized/coded shuffle modes keep
    this cost model honest about the volume they actually ship.
    """
    loads = np.asarray(loads, dtype=np.float64)
    if speeds is None:
        speeds = schedule.slot_speeds
    speeds = sched_lib.normalize_speeds(speeds, schedule.num_slots)
    if local_hist is not None:
        local_hist = np.asarray(local_hist, dtype=np.float64)
        if local_hist.shape != (schedule.num_slots, loads.shape[0]):
            raise ValueError(
                f"local_hist shape {local_hist.shape} does not match "
                f"(num_slots={schedule.num_slots}, n={loads.shape[0]})"
            )
    reduce_per_node = cluster.reduce_slots_per_node
    net_share = cluster.net_bw / reduce_per_node
    disk_r = cluster.disk_read_bw / reduce_per_node
    finish = 0.0
    for slot in range(schedule.num_slots):
        members = np.nonzero(schedule.assignment == slot)[0]
        if members.size == 0:
            continue
        slot_loads = loads[members]
        if local_hist is None:
            wire_pairs = slot_loads
        else:
            # Pairs of this slot's clusters that live on OTHER shards —
            # the only ones the copy phase ships (K − K^(slot) per §4.1).
            wire_pairs = np.maximum(slot_loads - local_hist[slot, members], 0.0)
        slow = 1.0 if speeds is None else 1.0 / float(speeds[slot])
        phases = pipe.PhaseTimes(
            # Copy pays only for pairs crossing the network; sort touches
            # every received pair (local shards included) regardless.
            copy=wire_pairs * bytes_per_pair / net_share * slow,
            sort=slot_loads * bytes_per_pair / (disk_r * 4.0) * slow,
            run=slot_loads / reduce_cpu_pps * slow,
        )
        if pipelined:
            res = pipe.run_pipelined(
                phases, order=pipe.plan_order(slot_loads, pipeline_order)
            )
        else:
            res = pipe.run_sequential(phases)
        finish = max(finish, res.finish_time)
    return finish


# Host "ops"/second for the scheduling-overhead model below. The constants
# only need the right *ordering* and rough magnitude: hash O(n) ≪
# LPT O(n log n) ≪ MULTIFIT O(iters·n·m) ≪ BSS O(n²/√η̃).
_HOST_RATE = 5e7


def scheduling_overhead(name: str, n: int, m: int, eta: float = 0.002) -> float:
    """Deterministic estimate (s) of a scheduler's own host-side cost."""
    n = max(1, int(n))
    m = max(1, int(m))
    if name == "hash":
        ops = float(n)
    elif name == "lpt":
        ops = n * max(1.0, math.log2(n))
    elif name == "multifit":
        ops = 20.0 * n * m
    elif name in ("bss", "os4m"):
        ops = float(n) ** 2 / max(math.sqrt(eta), 1e-3)
    else:
        ops = float(n) ** 2
    return ops / _HOST_RATE


def pick_strategy(
    loads: np.ndarray,
    num_slots: int,
    *,
    eta: float = 0.002,
    candidates: Tuple[str, ...] = sched_lib.AUTO_CANDIDATES,
    cluster: ClusterSpec = PAPER_CLUSTER,
    bytes_per_pair: float = 64,
    reduce_cpu_pps: float = 1.7e4,
    pipelined: bool = True,
    speeds: Optional[np.ndarray] = None,
    local_hist: Optional[np.ndarray] = None,
) -> Tuple[str, sched_lib.Schedule, Dict[str, float]]:
    """Choose the scheduling algorithm with the lowest estimated job cost.

    Returns ``(name, schedule, costs)`` where ``costs[name]`` is estimated
    Reduce makespan + scheduling overhead in model seconds. Ties resolve
    to the earlier (cheaper) candidate. ``speeds`` makes every candidate
    plan — and every makespan estimate — speed-aware (Q||C_max); under a
    straggler the imbalance term grows, so the picker naturally shifts
    from hash toward the speed-aware algorithms. ``local_hist`` /
    ``bytes_per_pair`` feed :func:`estimate_reduce_time`'s per-slot wire
    accounting — pass the engine's K^(i) statistics and *measured* wire
    rate so the picker sees real shuffle volume, not a uniform model.
    """
    loads = np.asarray(loads, dtype=np.float64)
    speeds = sched_lib.normalize_speeds(speeds, num_slots)
    n = loads.shape[0]
    best_name, best_sched, costs = None, None, {}
    for name in candidates:
        fn = sched_lib.get_scheduler(name)
        if name == "hash":
            schedule = fn(loads, num_slots, keys=np.arange(n), speeds=speeds)
        elif name in ("bss", "os4m"):
            schedule = fn(loads, num_slots, eta=eta, speeds=speeds)
        else:
            schedule = fn(loads, num_slots, speeds=speeds)
        cost = estimate_reduce_time(
            loads, schedule, cluster=cluster, bytes_per_pair=bytes_per_pair,
            reduce_cpu_pps=reduce_cpu_pps, pipelined=pipelined, speeds=speeds,
            local_hist=local_hist,
        ) + scheduling_overhead(name, n, num_slots, eta)
        costs[name] = cost
        if best_name is None or cost < costs[best_name]:
            best_name, best_sched = name, schedule
    return best_name, best_sched, costs


def estimate_replan_benefit(
    loads: np.ndarray,
    cached_schedule: sched_lib.Schedule,
    *,
    eta: float = 0.002,
    candidates: Tuple[str, ...] = sched_lib.AUTO_CANDIDATES,
    cluster: ClusterSpec = PAPER_CLUSTER,
    bytes_per_pair: float = 64,
    reduce_cpu_pps: float = 1.7e4,
    pipelined: bool = True,
    speeds: Optional[np.ndarray] = None,
    local_hist: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """Is replanning worth it, or is the stale schedule still good enough?

    The schedule-reuse cost model behind ``ReusePolicy(cost_gate=True)``:
    play the **cached** assignment against the **fresh** key distribution
    through the same flow-shop model as :func:`pick_strategy` (expected
    imbalance of staying stale), and compare with the best fresh
    candidate's makespan *plus its host scheduling overhead* (cost of
    replanning). A drifted distribution whose stale makespan still beats
    replan-cost − e.g. mild drift, expensive FPTAS − should keep reusing.

    Returns ``{"stale_makespan", "fresh_cost", "fresh_strategy",
    "benefit"}`` where ``benefit = stale_makespan - fresh_cost`` in model
    seconds; replan only when it is positive. ``speeds`` evaluates *both*
    sides under the current measured slot speeds — a stale schedule that
    piled work on a now-slow slot shows its true (inflated) makespan.
    """
    loads = np.asarray(loads, dtype=np.float64)
    speeds = sched_lib.normalize_speeds(speeds, cached_schedule.num_slots)
    stale = estimate_reduce_time(
        loads, cached_schedule, cluster=cluster, bytes_per_pair=bytes_per_pair,
        reduce_cpu_pps=reduce_cpu_pps, pipelined=pipelined, speeds=speeds,
        local_hist=local_hist,
    )
    name, _, costs = pick_strategy(
        loads, cached_schedule.num_slots, eta=eta, candidates=candidates,
        cluster=cluster, bytes_per_pair=bytes_per_pair,
        reduce_cpu_pps=reduce_cpu_pps, pipelined=pipelined, speeds=speeds,
        local_hist=local_hist,
    )
    fresh = costs[name]
    return {
        "stale_makespan": float(stale),
        "fresh_cost": float(fresh),
        "fresh_strategy": name,
        "benefit": float(stale - fresh),
    }


# ---------------------------------------------------------------------------
# Multi-job admission: weighted completion time on one shared mesh.
# ---------------------------------------------------------------------------


def wspt_order(times, weights=None):
    """Admission order minimising ``Σ wᵢ Cᵢ`` for sequential jobs (WSPT).

    When N jobs share one mesh and each runs with the full mesh (the OS4M
    schedule already balances *within* a job), the coordinator's freedom
    is the *order*. Weighted Shortest Processing Time — descending
    ``w_j / t_j`` — is exactly optimal for ``1 || Σ w C`` (Smith's rule)
    and is the admission rule the multi-job coordinator plans by.
    ``times`` are per-job estimated makespans (seconds or any consistent
    unit, e.g. from each job's row of the R-matrix); ties break by
    submission index (stable), so equal jobs keep FIFO fairness.
    """
    t = np.asarray(times, dtype=np.float64)
    w = (np.ones_like(t) if weights is None
         else np.asarray(weights, dtype=np.float64))
    if t.shape != w.shape:
        raise ValueError(f"times {t.shape} vs weights {w.shape}")
    if np.any(t < 0) or np.any(w < 0):
        raise ValueError("times and weights must be >= 0")
    # Sort by t/w ascending == w/t descending, without dividing by zero:
    # a zero-time or infinite-weight job goes first via the ratio's sign.
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(w > 0, t / np.where(w > 0, w, 1.0), np.inf)
    return np.argsort(ratio, kind="stable")


def weighted_completion_time(times, weights=None, order=None):
    """``Σ wᵢ Cᵢ`` when jobs run back-to-back in ``order``.

    ``C_j`` is the cumulative time until job ``j`` finishes. ``order=None``
    means FIFO (submission order) — the baseline WSPT is compared with.
    """
    t = np.asarray(times, dtype=np.float64)
    w = (np.ones_like(t) if weights is None
         else np.asarray(weights, dtype=np.float64))
    idx = np.arange(t.shape[0]) if order is None else np.asarray(order)
    completion = np.cumsum(t[idx])
    return float(np.sum(w[idx] * completion))
