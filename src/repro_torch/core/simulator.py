"""Discrete-event model of a Hadoop-class cluster running a MapReduce job.

The reference's ``repro.core.simulator`` in full, on the host (numpy; no
device code). Two parts:

* **The paper's job simulator** (:func:`simulate_job`): the *duration*
  figures of the paper (Figs 2, 7, 8, 9, 12, 13, 14, 15, 16 and Table 4)
  come from 8 worker VMs with measured bandwidths (network 37 MB/s, disk
  read 203 MB/s, disk write 121 MB/s), 4 Map + 4 Reduce slots per node,
  64 MB HDFS blocks and a 500 MB task heap. This module models exactly
  that cluster; its durations are model seconds of that cluster, never
  times on a device.
* **The schedule cost model** behind the engines: ``scheduler="auto"``
  (:func:`pick_strategy`), the reuse cost gate
  (:func:`estimate_replan_benefit`), and the serving engine's and the
  multi-job coordinator's admission order (:func:`wspt_order`,
  :func:`weighted_completion_time`).

Job model:

* A Map task reads its block from disk, applies the Map function (CPU rate
  per benchmark), and writes ``block * shuffle_ratio`` of intermediate data.
* **Hadoop mode**: Reduce copy begins as soon as the first Map wave ends and
  shares each node's disk+network bandwidth with still-running Map tasks.
  The contention multiplies Map I/O time by ``1 + c * f`` where ``f`` is the
  fraction of Map output already produced (this reproduces the wave
  pattern of Fig 2: 45 s → 86 s → very slow). The Reduce task then runs the
  three phases sequentially (Fig 4a), with an external multi-pass sort when
  its input exceeds the task heap.
* **OS4M mode**: Maps run contention-free; Reduce starts after the last Map,
  fetches per-operation-cluster bucket files, and streams clusters through
  the copy→sort→run pipeline in increasing-load order (Fig 4b,
  ``repro_torch.core.pipeline``). Small parts sort in memory.

The per-Reduce-slot loads come from an actual :mod:`repro_torch.core.scheduler`
schedule over a synthetic key distribution (zipf-like skew calibrated per
benchmark to the skew the paper reports in Fig 1).

:func:`synth_key_distribution` seeds its generator with
``seed + hash(spec.name) % 65536``, as the reference does. Python salts
``str`` hashes per process (``PYTHONHASHSEED``), so the distribution, and
every :func:`simulate_job` result built on it, differs from one process to
the next; within one process the port equals the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import pipeline as pipe
from repro_torch.core import scheduler as sched_lib

__all__ = [
    "ClusterSpec",
    "BenchmarkSpec",
    "SimResult",
    "PAPER_CLUSTER",
    "PUMA_BENCHMARKS",
    "synth_key_distribution",
    "simulate_job",
    "estimate_reduce_time",
    "scheduling_overhead",
    "pick_strategy",
    "estimate_replan_benefit",
    "wspt_order",
    "weighted_completion_time",
]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Paper §5: 8 worker VMs on IBM RC2; 9th VM runs JobTracker/NameNode."""

    num_nodes: int = 8
    map_slots_per_node: int = 4
    reduce_slots_per_node: int = 4
    net_bw: float = 37e6          # B/s per node (measured, paper §5)
    disk_read_bw: float = 203e6   # B/s per node
    disk_write_bw: float = 121e6  # B/s per node
    block_bytes: int = 64 * 2**20  # default HDFS block
    heap_bytes: int = 500 * 2**20  # task JVM heap (paper §5 point 4)
    # Hadoop map↔copy contention: wave slowdown = 1 + io_coeff * frac_output
    # * min(shuffle_bytes_per_node / pressure_ref, pressure_cap), capped at
    # factor_cap. io_coeff is per-benchmark (I/O intensity of the map task);
    # the per-NODE pressure makes both bigger shuffles and smaller clusters
    # contend harder (paper §5.5: "with fewer nodes, the data for each node
    # is larger ... contention is more intensive").
    pressure_ref: float = 0.75 * 2**30   # per node
    pressure_cap: float = 3.0
    factor_cap: float = 4.5

    @property
    def map_slots(self) -> int:
        """Cluster-wide Map slot count."""
        return self.num_nodes * self.map_slots_per_node

    @property
    def reduce_slots(self) -> int:
        """Cluster-wide Reduce slot count."""
        return self.num_nodes * self.reduce_slots_per_node


PAPER_CLUSTER = ClusterSpec()


@dataclasses.dataclass(frozen=True)
class BenchmarkSpec:
    """One PUMA benchmark (Table 2/3) with calibration knobs.

    ``zipf_alpha`` / ``num_keys`` shape the intermediate key distribution
    (Fig 1a showed 1 .. 1.97e6 pairs per operation for RII);
    ``shuffle_ratio`` = intermediate bytes / input bytes;
    ``map_cpu_bps`` / ``reduce_cpu_pps`` are the function costs.
    """

    name: str
    sizes_gb: Tuple[float, float, float]  # S, M, L (paper Table 3)
    zipf_alpha: float
    num_keys: int
    shuffle_ratio: float
    map_cpu_bps: float      # map function throughput, bytes/s
    reduce_cpu_pps: float   # reduce function throughput, pairs/s
    bytes_per_pair: int
    io_coeff: float         # map task I/O intensity (contention sensitivity)


# The reference's calibration (its benchmarks/fig14_job_duration.py prints
# the fit): Hadoop durations match Table 4, skew matches Fig 1/5/6
# qualitatively (II the hardest to balance, SJ nearly uniform), gains
# anchor Fig 14 (AL_L best ≈42 %, SJ_L worst ≈8 %).
PUMA_BENCHMARKS: Dict[str, BenchmarkSpec] = {
    "AL": BenchmarkSpec("AL", (5, 10, 15), 0.80, 60_000, 1.00, 3.9e5, 7.9e3, 96, 0.85),
    "II": BenchmarkSpec("II", (5, 10, 15), 0.97, 120_000, 0.55, 5.6e5, 1.1e4, 48, 0.70),
    "RII": BenchmarkSpec("RII", (10, 20, 30), 0.82, 90_000, 0.60, 8.4e5, 1.7e4, 64, 0.55),
    "SC": BenchmarkSpec("SC", (5, 10, 15), 0.75, 250_000, 1.20, 3.6e5, 7.3e3, 72, 0.60),
    "SJ": BenchmarkSpec("SJ", (10, 20, 30), 0.40, 150_000, 0.20, 1.2e6, 2.4e4, 56, 0.10),
    "TV": BenchmarkSpec("TV", (5, 10, 15), 0.82, 80_000, 0.45, 6.6e5, 1.3e4, 40, 0.60),
}


def synth_key_distribution(spec: BenchmarkSpec, input_bytes: float, seed: int = 0) -> np.ndarray:
    """Per-key pair counts with zipf skew, scaled to the job's shuffle volume."""
    rng = np.random.default_rng(seed + hash(spec.name) % 65536)
    ranks = np.arange(1, spec.num_keys + 1, dtype=np.float64)
    weights = ranks ** (-spec.zipf_alpha)
    # mild multiplicative noise so ties break realistically
    weights *= np.exp(rng.normal(0.0, 0.25, size=weights.shape))
    total_pairs = input_bytes * spec.shuffle_ratio / spec.bytes_per_pair
    counts = weights / weights.sum() * total_pairs
    return np.maximum(counts, 1.0)


@dataclasses.dataclass
class SimResult:
    """Per-job simulation outputs (the quantities the paper's figures plot)."""

    mode: str
    job_duration: float
    map_end: float
    avg_map_duration: float
    std_map_duration: float
    avg_reduce_duration: float
    std_reduce_duration: float
    avg_sort_delay: float
    avg_run_delay: float
    balance_ratio: float
    map_progress: List[Tuple[float, float]]     # (time, fraction complete)
    reduce_finish: List[float]
    phase_times: Dict[str, float]               # avg copy/sort/run busy per task


def _map_phase(
    cluster: ClusterSpec,
    spec: BenchmarkSpec,
    num_maps: int,
    mode: str,
    input_bytes: float,
) -> Tuple[float, np.ndarray, List[Tuple[float, float]]]:
    """Returns (map_end_time, per-task durations, progress trace).

    Hadoop contention model: once any Map output exists, Reduce copy flows
    share each node's disk and NIC with running Map tasks; a Map task stalls
    on I/O in proportion to (a) how much output is available to copy
    (``frac_output``, grows wave by wave — Fig 2's 45 s → 86 s → "extremely
    slow") and (b) the job's copy pressure (total shuffle volume relative to
    the cluster's drain capacity — Table 4's superlinear growth with size).
    OS4M removes the overlap entirely (§4.1 step 6), so its waves are flat
    (Fig 9's consistent progress rate).
    """
    base_io = (
        cluster.block_bytes / (cluster.disk_read_bw / cluster.map_slots_per_node)
        + (cluster.block_bytes * spec.shuffle_ratio)
        / (cluster.disk_write_bw / cluster.map_slots_per_node)
    )
    base_cpu = cluster.block_bytes / spec.map_cpu_bps
    base_wave = base_io + base_cpu
    shuffle_bytes = input_bytes * spec.shuffle_ratio
    pressure = min(shuffle_bytes / cluster.num_nodes / cluster.pressure_ref,
                   cluster.pressure_cap)
    waves = math.ceil(num_maps / cluster.map_slots)
    durations = np.zeros(num_maps)
    progress: List[Tuple[float, float]] = [(0.0, 0.0)]
    t = 0.0
    done = 0
    for _ in range(waves):
        tasks = min(cluster.map_slots, num_maps - done)
        if mode == "hadoop":
            frac_output = done / num_maps
            factor = min(
                1.0 + spec.io_coeff * frac_output * pressure, cluster.factor_cap
            )
        else:
            factor = 1.0
        wave_time = base_wave * factor
        durations[done : done + tasks] = wave_time
        t += wave_time
        done += tasks
        progress.append((t, done / num_maps))
    return t, durations, progress


def _reduce_loads(
    spec: BenchmarkSpec,
    input_bytes: float,
    num_reduce: int,
    num_clusters: int,
    mode: str,
    seed: int = 0,
) -> Tuple[np.ndarray, sched_lib.Schedule, np.ndarray]:
    """Key distribution → clusters → schedule → per-slot cluster load lists."""
    key_counts = synth_key_distribution(spec, input_bytes, seed)
    from repro_torch.core import clustering

    key_ids = np.arange(key_counts.shape[0])
    cids = clustering.cluster_ids_for_keys(
        sched_lib._default_hash(key_ids).astype(np.int64), num_clusters
    )
    cl_loads = clustering.cluster_loads(key_counts, cids, num_clusters)
    if mode == "hadoop":
        schedule = sched_lib.schedule_hash(cl_loads, num_reduce, keys=np.arange(num_clusters))
    else:
        schedule = sched_lib.schedule_bss(cl_loads, num_reduce)
    return cl_loads, schedule, key_counts


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
    older generation), which is the model
    :mod:`repro_torch.core.slot_speeds` estimates against. ``None`` falls
    back to the schedule's own recorded speeds (nominal when those are
    unset).

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


def simulate_job(
    benchmark: str,
    size: str,
    mode: str,
    cluster: ClusterSpec = PAPER_CLUSTER,
    num_reduce: int = 30,           # paper §5: 0.95 * 8 * 4 ≈ 30
    num_clusters: int = 240,        # paper §5: clustering kicks in above 240
    pipeline_order: str = "increasing",
    seed: int = 0,
) -> SimResult:
    """Simulate one (benchmark, dataset, mode) job. mode ∈ {hadoop, os4m}."""
    spec = PUMA_BENCHMARKS[benchmark]
    size_idx = {"S": 0, "M": 1, "L": 2}[size]
    input_bytes = spec.sizes_gb[size_idx] * 2**30
    num_maps = math.ceil(input_bytes / cluster.block_bytes)

    map_end, map_durs, progress = _map_phase(
        cluster, spec, num_maps, mode, input_bytes
    )

    cl_loads, schedule, _ = _reduce_loads(
        spec, input_bytes, num_reduce, num_clusters, mode, seed
    )

    # Per-node bandwidth shares for Reduce-phase resources.
    reduce_per_node = cluster.reduce_slots_per_node
    net_share = cluster.net_bw / reduce_per_node
    disk_r = cluster.disk_read_bw / reduce_per_node
    disk_w = cluster.disk_write_bw / reduce_per_node

    reduce_finish: List[float] = []
    reduce_durations: List[float] = []
    sort_delays: List[float] = []
    run_delays: List[float] = []
    busy = {"copy": 0.0, "sort": 0.0, "run": 0.0}

    for slot in range(num_reduce):
        members = np.nonzero(schedule.assignment == slot)[0]
        loads = cl_loads[members]  # pairs per cluster on this slot
        if loads.size == 0:
            reduce_finish.append(map_end)
            reduce_durations.append(0.0)
            sort_delays.append(0.0)
            run_delays.append(0.0)
            continue
        byte_loads = loads * spec.bytes_per_pair
        copy_t = byte_loads / net_share
        run_t = loads / spec.reduce_cpu_pps
        if mode == "os4m":
            # §4.4: per-cluster parts; parts under the heap sort in memory.
            in_mem = byte_loads <= cluster.heap_bytes
            mem_sort = byte_loads / (disk_r * 4.0)          # memory-speed sort
            dsk_sort = byte_loads / disk_r + byte_loads / disk_w
            sort_t = np.where(in_mem, mem_sort, dsk_sort)
            res = pipe.run_pipelined(
                pipe.PhaseTimes(copy_t, sort_t, run_t),
                order=pipe.plan_order(loads, pipeline_order),
                start=map_end,
            )
        else:
            total_bytes = float(byte_loads.sum())
            passes = 1 if total_bytes <= cluster.heap_bytes else (
                2 if total_bytes <= 8 * cluster.heap_bytes else 3
            )
            whole_sort = passes * (total_bytes / disk_r + total_bytes / disk_w)
            # Hadoop overlapped its copy phase with Maps: it has been copying
            # since the first wave finished, at the contended rate.
            first_wave_end = map_end / max(
                1, math.ceil(num_maps / cluster.map_slots)
            )
            overlap_window = max(0.0, map_end - first_wave_end)
            head_start = min(float(copy_t.sum()), overlap_window * 0.6)
            res = pipe.run_sequential(
                pipe.PhaseTimes(copy_t, np.zeros_like(copy_t), run_t),
                start=map_end,
                copy_head_start=head_start,
                whole_task_sort=whole_sort,
            )
        reduce_finish.append(map_end + res.finish_time)
        reduce_durations.append(res.finish_time)
        sort_delays.append(res.sort_delay)
        run_delays.append(res.run_delay)
        busy["copy"] += res.copy_busy
        busy["sort"] += res.sort_busy
        busy["run"] += res.run_busy

    nr = max(1, num_reduce)
    return SimResult(
        mode=mode,
        job_duration=max(reduce_finish) if reduce_finish else map_end,
        map_end=map_end,
        avg_map_duration=float(map_durs.mean()),
        std_map_duration=float(map_durs.std()),
        avg_reduce_duration=float(np.mean(reduce_durations)),
        std_reduce_duration=float(np.std(reduce_durations)),
        avg_sort_delay=float(np.mean(sort_delays)),
        avg_run_delay=float(np.mean(run_delays)),
        balance_ratio=schedule.balance_ratio,
        map_progress=progress,
        reduce_finish=reduce_finish,
        phase_times={k: v / nr for k, v in busy.items()},
    )


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
