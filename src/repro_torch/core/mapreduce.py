"""A keyed Map/Shuffle/Reduce engine on GPUs with OS4M scheduling.

The paper's whole workflow —

    map  →  collect per-key statistics  →  (host) Q||C_max schedule
         →  chunked shuffle ("copy")    →  pipelined segment reduce ("run")
         →  measure per-slot wave timings → update slot-speed estimate

as two device phases around a host planning step. Phase boundaries match
the paper: Reduce work begins only after *all* Map operations have
finished and the schedule is known (§4.1 step 6).

Two backends run the ``m`` Reduce slots:

* ``backend="stacked"`` — the slots are a leading ``(m,)`` axis of every
  tensor on one device, the counterpart of the reference's
  ``backend="vmap"``: one launch serves every slot, and the reference's
  ``psum`` over slots is a sum over that axis. No copy leaves the device,
  so phase B keeps only the kept pairs, as indices into the Map output,
  and the all-to-all "copy" of a chunk moves nothing.
* ``backend="sharded"`` — the counterpart of ``backend="shard_map"``: one
  controller (this process) plans once and runs one program per slot,
  each on its own device (``devices=``) and CUDA stream, on a ``(1, K)``
  slice. The collectives are device-to-device copies and reductions
  ordered by CUDA events: the chunk "copy" gathers ``send[src][dst]`` of
  every sender after its spill event, ``psum`` is a sum of per-slot
  scalars and ``pmax`` a maximum.

Both drive ONE phase-B body (:func:`_phase_b_body`), a generator that
yields at each collective; the backend's runner performs it. Each slot's
program is the body over its rows, so the backends agree bit for bit.

Q||C_max speeds: ``speeds`` pins a per-slot speed vector;
``estimate_speeds`` learns one online (:class:`~repro_torch.core.
slot_speeds.SlotSpeedEstimator`). On the stacked backend the estimator
reads a synthetic model (work × injected slowdown: one device has no
per-slot clocks); on the sharded backend it reads measured wave clocks —
the same body with a ``stamp_through`` hook (``kernels/wave_timer``,
``%globaltimer`` stamps on each slot's stream), so a measured batch is
bit-identical to an unmeasured one by construction.

Phase A maps the input and builds every slot's ``K^(i)`` histogram in one
launch of the histogram kernel (one a slot on the sharded backend). The host pulls the ``(m, n)`` float32
statistics and plans: the schedule, the §4.4 waves (chunks of clusters in
increasing-load order) and the statistics-sized send capacities, which
decide the pairs kept. Phase B spills every chunk in one sort, then walks
the chunks: the "copy" of chunk ``c+1`` is issued before the reduce of
chunk ``c``, and each chunk's "run" is one launch of the fused gather +
segment-sum kernel, on pairs ordered by pipeline rank. On the stacked
backend the spill stable-sorts the kept pairs by (chunk, rank) once and
the kernel gathers them straight from the Map output; the sharded
backend lays out each chunk's padded bucket file, copies bucket ``[src,
dst]`` between devices and sorts what it received by rank. Each cluster's
pairs reach the kernel in sender order, then stream order, on both, so
they agree bit for bit. Sums accumulate in float32 (the CUDA kernel takes
float32 values).

Statistics are pluggable (``stats``): the exact ``(m, n)`` histogram
(the histogram kernel) or a count-min sketch of ``depth x width`` cells
per slot (the sketch kernel), from which the host plans at bin
granularity with overestimate-only capacities; ``stream_prefix`` plans
wave 1 from a sketch of each slot's first pairs and refines the rest
from the full sketch, with an exact overflow escape hatch. Outputs are
the same under either statistics. ``scheduler="auto"`` picks the
strategy with the lowest estimated Reduce makespan
(``simulator.pick_strategy``).

Coded shuffle (``shuffle_replication=2``, Coded MapReduce, arXiv
1512.01625): every record is also held by one partner slot, and phase B
sends one XOR multicast packet per slot pair instead of two unicast slabs
(the XOR word kernel encodes and decodes them). Receivers re-order what
they decode into the uncoded stream's ``(src, position)`` order before
the same reduce, so outputs are bit-identical to the uncoded engine.
``quantize_shuffle`` ships int8 (one global scale) or fp8 payloads; every
delivered value goes through encode → decode, so coded and uncoded runs
of one quantized job agree bit for bit.

Elastic mesh: slots can die (``set_slot_failure``; a dead slot's speed is
an exact 0.0, so every planner assigns it nothing), rejoin, and the mesh
can be resized (``resize``: every per-slot structure is truncated or
padded, and a cached plan is re-projected onto the new slot count instead
of going cold). With ``checkpoint_waves`` phase B walks the waves one
fenced copy → run pair at a time and checkpoints each finished wave on
the host; a slot killed mid-batch (``set_slot_failure(i, at_wave=w)``)
replays only the unfinished waves on the survivors, and outputs stay
bit-identical to an uninterrupted run.

Steady-state serving: with ``MapReduceConfig(reuse=ReusePolicy(...))``
each plan is snapshotted in a :class:`~repro_torch.core.schedule_cache.
ScheduleCache` and replayed while the measured statistics stay close (a
drift reduction on the device against a baseline uploaded once; only the
scalar reaches the host). A reused batch pulls only the ``(S,)`` slot-sum
of the statistics, calls no scheduler, and re-executes with a fresh plan
if its replayed buffers overflow. The reference keys jitted executables
on plan shapes, and its reused batches show "zero retraces". The port
compiles nothing per shape: each CUDA library is built and loaded once
per process and its kernels take any shape. Its counterpart of the rule
is therefore: a reused batch calls the planner zero times and uploads no
baseline again.

On CUDA tensors the kernels run; on CPU tensors their plain PyTorch
versions run, with the same semantics — the reference's
``use_kernels=True`` path either way, so the tests hold the port against
the reference on the CPU.

Data model: ``map_fn(inputs)`` returns stacked tensors ``(key_hashes (m,
K) int32, values (m, K, V) float, valid (m, K) bool)``: up to ``K``
intermediate pairs per slot. Keys are pre-hashed by the user's map
function.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import allowlist
from repro_torch.core import clustering
from repro_torch.core import mesh_timing as mt
from repro_torch.core import pipeline as pipe
from repro_torch.core import schedule_cache as sc
from repro_torch.core import scheduler as sched_lib
from repro_torch.core import simulator as sim
from repro_torch.core import slot_speeds as ss
from repro_torch.core import spans
from repro_torch.core import stats_provider as sp
from repro_torch.device import default_device
from repro_torch.kernels import _build
from repro_torch.kernels.coded_shuffle import ops as cs_ops
from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops
from repro_torch.kernels.wave_timer import ops as wt_ops

__all__ = ["MapReduceConfig", "JobResult", "MapReduceJob"]

_INT32_MIN = -(2 ** 31)
REDUCE_OPS = ("sum", "max", "count")
BACKENDS = ("stacked", "sharded")
_FP8 = torch.float8_e4m3fn
# Half-way between 448, e4m3fn's largest finite value, and 480: the
# reference's cast rounds every larger magnitude (and +-inf) to NaN, while
# PyTorch's saturates it to +-448.
_FP8_NAN_ABOVE = 464.0


@dataclasses.dataclass(frozen=True)
class MapReduceConfig:
    """Static configuration of one :class:`MapReduceJob`.

    ``reuse`` switches the job into steady-state mode: plans are cached
    in a :class:`repro_torch.core.schedule_cache.ScheduleCache` and
    replayed until the policy (drift / age / speed drift / overflow)
    demands a replan.

    Heterogeneous slots (Q||C_max): ``speeds`` pins a known per-slot
    relative speed vector. Speeds only move *where* clusters are reduced
    — outputs are bit-identical under any speed vector.

    ``stats="sketch"`` plans from a per-slot count-min sketch of
    ``sketch_depth x sketch_width`` cells instead of the ``(m, n)``
    histogram; outputs stay bit-identical to the exact path, since
    estimates only over-provision capacities. ``stream_prefix`` (sketch
    only, in ``(0, 1]``) plans wave 1 from a sketch of the first
    ``stream_prefix`` fraction of each slot's pairs, scaled up, and
    refines the other waves from the full sketch; a committed wave-1 cap
    that under-provisions re-executes the batch at the safe bound.

    ``shuffle_replication=2`` runs the coded shuffle: each record is
    pair-placed on two slots and phase B ships XOR multicast packets,
    with outputs bit-identical to ``1`` (uncoded); the replica exchange's
    bytes are accounted apart (``JobResult.replication_bytes``).
    ``quantize_shuffle`` (``"int8"``: symmetric, one global scale a batch;
    ``"fp8"``: a ``float8_e4m3fn`` cast) is a lossy wire format: every
    delivered value, local pairs included, goes through encode → decode,
    and ``JobResult.quantize_exact`` says whether that changed any record.

    Heterogeneous slots also learn their speeds online:
    ``estimate_speeds`` folds phase-B wave timings into a
    :class:`~repro_torch.core.slot_speeds.SlotSpeedEstimator` (EWMA weight
    ``speed_ewma``). ``measure_timings`` picks the timing source: ``None``
    resolves to *measured* per-slot wave clocks on the sharded backend
    and to the synthetic work/slowdown model on the stacked one (one
    device has no per-slot clocks); ``True`` forces the measured path
    (needs ``backend="sharded"`` and ``estimate_speeds``); ``False``
    disables it. Measured runs use the same overlapped pipeline with
    per-wave stamps on each slot's stream; without a tick source the
    executor falls back to wave-fenced host timing.

    Elastic mesh: ``checkpoint_waves`` walks phase B one fenced wave at a
    time with host checkpoints, so a slot killed mid-batch
    (``MapReduceJob.set_slot_failure(slot, at_wave=w)``) replays only the
    unfinished waves on the surviving slots. It needs exact statistics,
    the exact uncoded wire and the synthetic timing model.
    """

    num_slots: int                      # m — Reduce slots
    num_clusters: int                   # n — operation clusters (§4.3)
    scheduler: str = "os4m"             # hash | lpt | multifit | bss | os4m | auto
    eta: float = 0.002                  # FPTAS precision (paper §5: 0.2%)
    reduce_op: str = "sum"              # sum | max | count
    pipeline_chunks: int = 4            # Reduce pipeline granularity (§4.4)
    pipelined: bool = True              # False = Hadoop-style single-shot phase B
    capacity_send: Optional[int] = None  # per-(shard,dest) send buffer; None = safe bound
    speeds: Optional[Tuple[float, ...]] = None  # static per-slot speeds (1.0 = nominal)
    reuse: Optional[sc.ReusePolicy] = None  # schedule-reuse policy; None = replan per run
    estimate_speeds: bool = False       # learn speeds online from phase-B timings
    speed_ewma: float = 0.4             # estimator smoothing (newest-sample weight)
    measure_timings: Optional[bool] = None  # real per-slot wave clocks (sharded)
    checkpoint_waves: bool = False      # wave checkpoints (elastic mesh)
    shuffle_replication: int = 1        # 1 uncoded | 2 coded pair placement
    quantize_shuffle: Optional[str] = None  # None | int8 | fp8 wire payload
    stats: str = "exact"                # exact | sketch (count-min statistics)
    sketch_width: int = 1024            # count-min columns (power of two >= 8)
    sketch_depth: int = 4               # count-min hash rows (min over rows)
    stream_prefix: Optional[float] = None   # streaming-prefix planning (sketch only)


@dataclasses.dataclass
class JobResult:
    """Outputs + provenance of one ``run()`` (fresh plan or cached replay).

    The reference's fields that the port can fill.
    """

    values: np.ndarray          # (num_clusters, V) reduced outputs
    counts: np.ndarray          # (num_clusters,) pairs per cluster
    schedule: sched_lib.Schedule
    key_distribution: np.ndarray  # K = (k_1..k_n) (cluster loads, §4.1)
    overflow: int               # pairs dropped by capacity clamp (0 in normal runs)
    network_cost: clustering.NetworkCost
    strategy: str = ""          # scheduler actually used ("auto" resolves here)
    strategy_costs: Optional[dict] = None  # auto mode: estimated cost per candidate
    reused: bool = False        # True = phase B replayed a cached schedule
    plan_reason: str = ""       # ReuseDecision.reason ("" when reuse is off)
    drift: Optional[float] = None  # drift metric, when it was computed this run
    replan_benefit: Optional[dict] = None  # cost-gate verdict (auto + cost_gate)
    slot_speeds: Optional[np.ndarray] = None  # speeds the plan was built for
    speed_drift: Optional[float] = None  # slot-speed change vs the cached plan
    # Bytes-on-the-wire of phase B's shuffle: rows counted on the device,
    # converted to bytes with the static row size (payload + 4-byte id).
    shuffle_bytes: Optional[int] = None   # a2a payload bytes (packets once per multicast)
    shuffle_rows: Optional[int] = None    # wire rows behind those bytes
    shuffle_pairs: Optional[int] = None   # non-local pairs the wire carried
    replication_bytes: int = 0            # coded replica-exchange bytes (not shuffle)
    quantize_exact: Optional[bool] = None  # quantized round trip lossless? (None = off)
    # Rows phase B laid out and sorted for the reduce, from shapes (no
    # sync), summed over the run's executions: each pair once where one
    # device holds every slot, the padded bucket files otherwise; None for
    # a coded plan, whose wire has a layout of its own.
    bucket_rows: Optional[int] = None


def _resolve_measure(cfg: MapReduceConfig, backend: str) -> bool:
    """The timing source: measured per-slot clocks or the synthetic model.

    ``None`` means measured on the sharded backend when speeds are
    estimated; ``True`` is refused where the reference refuses it.
    """
    measure = cfg.measure_timings
    if measure is None:
        return backend == "sharded" and cfg.estimate_speeds
    if measure:
        if backend != "sharded":
            raise ValueError(
                "measure_timings=True needs backend='sharded' — per-slot"
                " clocks do not exist on a single stacked device")
        if not cfg.estimate_speeds:
            raise ValueError(
                "measure_timings=True without estimate_speeds=True would "
                "measure timings nothing consumes")
    return bool(measure)


def _validate_wire(cfg: MapReduceConfig, measured: bool) -> None:
    """The reference's ``ValueError``s for the coded and quantized wire and
    for measured timings beside them (``measured`` is the resolved source).

    Checked before the unported settings, so a combination the reference
    refuses is refused alike, not reported as not ported.
    """
    if cfg.shuffle_replication not in (1, 2):
        raise ValueError(
            "shuffle_replication must be 1 (uncoded) or 2 (coded pair"
            f" placement), got {cfg.shuffle_replication}")
    if cfg.quantize_shuffle not in (None, "int8", "fp8"):
        raise ValueError(
            f"quantize_shuffle must be None, 'int8' or 'fp8', got"
            f" {cfg.quantize_shuffle!r}")
    if cfg.shuffle_replication > 1:
        if cfg.num_slots < 2:
            raise ValueError(
                "shuffle_replication=2 needs at least 2 slots (the pair"
                " placement replicates across distinct slots)")
        if cfg.checkpoint_waves:
            raise ValueError(
                "shuffle_replication>1 is incompatible with checkpoint_waves —"
                " the checkpointed walk has its own per-wave copy programs")
        if measured:
            raise ValueError(
                "shuffle_replication>1 is incompatible with measured timings —"
                " the coded decode is not stamp-instrumented; set"
                " measure_timings=False to combine coding with speed"
                " estimation (synthetic model)")
    if cfg.quantize_shuffle and cfg.checkpoint_waves:
        raise ValueError(
            "quantize_shuffle is incompatible with checkpoint_waves — the"
            " checkpointed copy programs ship the exact wire")
    if cfg.checkpoint_waves and measured:
        raise ValueError(
            "checkpoint_waves=True is incompatible with measured timings —"
            " both own the fenced phase-B program structure; set"
            " measure_timings=False (synthetic model) to combine fault"
            " tolerance with speed estimation")


# ---------------------------------------------------------------------------
# Phase bodies over a group of slots: a leading rows axis, all m slots on
# the stacked backend, one slot on the sharded backend.
# ---------------------------------------------------------------------------


def _cluster_ids(key_hashes: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """``|key_hash| % n`` with the reference's int32 semantics.

    ``abs`` keeps INT32_MIN negative (two's-complement wraparound) and
    ``%`` is a floor-mod, so every id lands in ``[0, n)``; ``torch.fmod``
    or an int64 ``abs`` would give other ids for negative hashes.
    """
    kh = key_hashes.to(torch.int32)
    mag = torch.where(kh == _INT32_MIN, kh, kh.abs())
    return torch.remainder(mag, num_clusters)


def _phase_a(inputs, map_fn: Callable, num_clusters: int, stats_fn: Callable,
              prefix_fraction: Optional[float] = None):
    """Map + local statistics (paper §4.1 steps 1–3) for every slot.

    Returns ``((key_hashes, values, valid), state)``; ``state`` is the
    provider's ``(m, S)`` float32 statistics — the TaskTracker →
    JobTracker report of §4.1: the exact histogram (``S = n``) or the
    count-min cells (``S = depth * width``).

    ``prefix_fraction`` (streaming ingestion): additionally collect the
    statistics of only the first ``ceil(fraction * K)`` pair positions of
    every slot — the pairs that would have "landed first" in a streaming
    deployment — and return ``cat([full_state, prefix_state], dim=1)``.
    """
    key_hashes, values, valid = map_fn(inputs)
    key_hashes = key_hashes.to(torch.int32)
    valid = valid.to(torch.bool)
    cluster_ids = _cluster_ids(key_hashes, num_clusters)
    # The mask is the weight: the kernels' mask instance reads it as bytes.
    state = stats_fn(cluster_ids, valid)
    if prefix_fraction is not None:
        k = int(cluster_ids.shape[1])
        cut = int(np.ceil(prefix_fraction * k))
        in_prefix = torch.arange(k, device=valid.device) < cut
        state = torch.cat([state, stats_fn(cluster_ids, valid & in_prefix)], dim=1)
    return (key_hashes, values, valid), state


def _ragged_counting_sort_to_buckets(
    group: torch.Tensor,     # (m, K) int32 in [0, G] (G = invalid)
    values: torch.Tensor,    # (m, K, V)
    payload: torch.Tensor,   # (m, K) int32 cluster ids
    group_caps: np.ndarray,  # (G,) static per-group capacities
    total: int,              # = group_caps.sum()
):
    """One-pass counting sort of every slot into *ragged* group buffers.

    A pair's position inside its group is its rank in a stable sort of
    the group ids, so each group keeps its pairs in stream order and the
    ones past the group's capacity overflow (drop-newest). Overflowed and
    invalid pairs are written to a dump row at index ``total``, which is
    dropped. Returns ``(m, total, V)`` / ``(m, total)`` buffers and the
    exact overflow count over all slots (a device scalar).
    """
    m, k = group.shape
    dev = group.device
    num_groups = group_caps.shape[0]
    base = np.zeros(num_groups, np.int64)
    base[1:] = np.cumsum(group_caps)[:-1]
    order = torch.argsort(group, dim=1, stable=True)
    g_sorted = torch.gather(group, 1, order)
    pos = torch.arange(k, device=dev) - torch.searchsorted(g_sorted, g_sorted, side="left")
    g_clip = g_sorted.clamp(0, num_groups - 1).long()
    cap_of = torch.as_tensor(group_caps, device=dev)[g_clip]
    in_range = g_sorted < num_groups
    ok = in_range & (pos < cap_of)
    overflow = (in_range & (pos >= cap_of)).sum()
    flat = torch.where(ok, torch.as_tensor(base, device=dev)[g_clip] + pos, total)
    # Bucket row of every pair in its original position: the values are
    # scattered straight from the input, with no sorted copy of them.
    row_of = torch.empty_like(flat).scatter_(1, order, flat)
    v_dim = values.shape[-1]
    bucket_values = values.new_zeros((m, total + 1, v_dim)).scatter_(
        1, row_of[..., None].expand(m, k, v_dim), values)[:, :total]
    bucket_clusters = torch.full((m, total + 1), -1, dtype=torch.int32, device=dev)
    bucket_clusters = bucket_clusters.scatter_(1, row_of, payload.to(torch.int32))[:, :total]
    bucket_valid = torch.zeros((m, total + 1), dtype=torch.bool, device=dev)
    bucket_valid = bucket_valid.scatter_(1, flat, ok)[:, :total]
    return bucket_values, bucket_clusters, bucket_valid, overflow


def _wire_rows(bucket_valid: torch.Tensor, me: torch.Tensor) -> torch.Tensor:
    """Rows crossing the network: all bucketed rows but each sender's own.

    ``bucket_valid`` is ``(rows, m, cap)``: the buckets of slots ``me``
    (one a row) to every destination; a slot's bucket to itself is
    delivered locally.
    """
    own = bucket_valid[torch.arange(bucket_valid.shape[0], device=me.device), me]
    return bucket_valid.sum() - own.sum()


def _key_dtype(num_keys: int) -> torch.dtype:
    """int16 where it holds keys ``[0, num_keys]``, else int32: a radix sort
    makes one pass a byte of its keys."""
    return torch.int16 if num_keys < 2 ** 15 else torch.int32


def _kept_places(group: torch.Tensor, group_caps: np.ndarray):
    """Which pairs their group's capacity keeps, every slot at once, with
    no bucket file: the placement of the :class:`_Kept` spill.

    ``group (rows, K)`` int32 in ``[0, G]`` (``G`` = invalid), ``group_caps``
    the ``(G,)`` static capacities. One stable sort orders the pairs by
    their ``(row, group)`` key, ``row · (G + 1) + group``, so each group's
    pairs form a run in stream order; the group keeps the first ``cap``
    of its run and the rest overflow (drop-newest), as
    :func:`_ragged_counting_sort_to_buckets` drops them. Returns ``(kept
    (rows, K) bool in stream order, kept_of (rows, G) the pairs each
    (row, group) keeps, overflow)``, the last a device scalar.
    """
    rows, k = group.shape
    dev = group.device
    span = group_caps.shape[0] + 1
    dtype = _key_dtype(rows * span)
    row_key = torch.arange(rows, device=dev, dtype=dtype)[:, None] * span
    key, order = torch.sort((group.to(dtype) + row_key).view(-1), stable=True)
    start = torch.searchsorted(key, torch.arange(rows * span + 1, device=dev, dtype=dtype))
    fill = start[1:] - start[:-1]
    caps = torch.as_tensor(np.append(group_caps, 0), device=dev).repeat(rows)
    kept = torch.minimum(fill, caps)
    # Each run keeps its first `kept` places: +1 where a kept stretch
    # starts and -1 where it ends, summed along the sorted places.
    edge = torch.zeros(rows * k + 1, dtype=torch.int32, device=dev)
    edge.index_add_(0, torch.cat([start[:-1], start[:-1] + kept]),
                    torch.cat([torch.ones_like(kept), -torch.ones_like(kept)]).to(torch.int32))
    ok = torch.cumsum(edge[:-1], 0, dtype=torch.int32) > 0
    overflow = (fill - kept).view(rows, span)[:, :-1].sum()
    in_stream = torch.empty_like(ok).scatter_(0, order, ok).view(rows, k)
    return in_stream, kept.view(rows, span)[:, :-1], overflow


class _Kept(NamedTuple):
    """Phase B's spill where one device holds every sender: the kept pairs
    as indices into the Map output, with no bucket file.

    ``values`` is the ``(1, rows · K, V)`` delivered values, sender-major.
    ``keys`` gives each pair ``chunk · (n + 1) + rank`` of its cluster, or
    ``chunks · (n + 1)`` where it is invalid or dropped. For ``sum``,
    ``order`` is the int32 stable sort of the keys and ``keys`` are sorted:
    each chunk's kept pairs are then contiguous, in rank order, and each
    cluster's in sender order, then stream order, the order in which a
    copy to its slot and a stable sort by rank deliver them. For ``max``
    and ``count``, which no order changes, ``order`` is ``None`` and
    ``keys`` are in stream order. ``me`` holds the rows' slots.
    """

    values: torch.Tensor
    keys: torch.Tensor
    order: Optional[torch.Tensor]
    me: torch.Tensor
    num_clusters: int


def _copy_chunk(kept: _Kept, chunk: int) -> torch.Tensor:
    """The "copy" of chunk ``chunk`` where one device holds every sender.

    Nothing moves: the chunk's kept pairs are in ``kept`` already. Returns
    the ``(1, rows · K)`` int32 segment row of the reduce: ``-1`` before the
    chunk's keys, each pair's rank inside them and ``n`` after them. On
    sorted keys the row is non-decreasing, as kernel 2 takes it; ids
    outside ``[0, n)`` are padding.
    """
    with spans.stage("phase_b.copy"):
        n = kept.num_clusters
        return (kept.keys - chunk * (n + 1)).clamp_(-1, n).to(torch.int32)


@allowlist.exact_accumulate
def _segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``(m, R, W)`` rows summed by ``seg (m, R)`` in ``[0, S]`` → ``(m, S, W)``.

    Id ``S`` is the dump segment and is dropped. Every caller sums 0/1
    indicators (pair counts): integer-valued sums, exact in any order of
    additions while below the dtype's integer limit (2^24 in float32), so
    the determinism checker takes its ``index_add_`` as declared exact.
    """
    m, _, w = data.shape
    flat = seg + torch.arange(m, device=seg.device)[:, None] * (num_segments + 1)
    out = data.new_zeros((m * (num_segments + 1), w))
    out.index_add_(0, flat.reshape(-1), data.reshape(-1, w))
    return out.view(m, num_segments + 1, w)[:, :num_segments]


def _segment_reduce(cluster_ids, values, valid, num_clusters: int, reduce_op: str):
    """The "run" of ``max`` and ``count``: aggregate pairs per cluster.

    Neither depends on the order of the pairs (a maximum, or a float sum
    of ones), so no sort precedes it. ``count`` returns ``(m, n, 1)``, as
    the reference does.
    """
    seg = torch.where(valid, cluster_ids.long(), num_clusters)
    counts = _segment_sum(valid.to(torch.float32)[..., None], seg, num_clusters)[..., 0]
    if reduce_op == "max":
        m, _, v_dim = values.shape
        masked = torch.where(valid[..., None], values, torch.finfo(values.dtype).min)
        out = torch.full((m, num_clusters + 1, v_dim), -torch.inf,
                         dtype=values.dtype, device=values.device)
        out.scatter_reduce_(1, seg[..., None].expand_as(values), masked, "amax")
        out = torch.where(counts[..., None] > 0, out[:, :num_clusters], 0.0)
    elif reduce_op == "count":
        out = _segment_sum(valid.to(values.dtype)[..., None], seg, num_clusters)
    else:
        raise ValueError(f"unknown reduce_op {reduce_op!r}")
    return out, counts


def _rank_order(rc, rm, rank_of_cluster, num_clusters: int):
    """The "sort" of a received chunk: stream order by pipeline rank.

    Rank (increasing cluster load, §4.4) is monotone along the sorted
    stream; invalid rows take rank ``n``, the fused kernel's padding id.
    The sort is stable, so each cluster's pairs keep their arrival order.
    Returns ``(order, rank_sorted)``, both ``(m, R)`` int32.
    """
    rank = torch.where(rm, rank_of_cluster[rc.clamp(0, num_clusters - 1).long()],
                       num_clusters).to(torch.int32)
    order = torch.argsort(rank, dim=1, stable=True)
    return order.to(torch.int32), torch.gather(rank, 1, order)


def _reduce_chunk(rv, rc, rm, rank_of_cluster, num_clusters: int, reduce_op: str):
    """The "sort" + "run" of one received chunk, every slot at once.

    ``sum``: pairs ordered by rank go through the fused gather +
    segment-sum kernel in one pass (float32 sums, and each rank's pair
    count from its row range), and both are un-permuted back to cluster
    ids with one gather each (``rank_of_cluster`` is a permutation, and
    every valid pair's rank is its cluster's). ``max`` / ``count``:
    :func:`_segment_reduce`. Also the whole of the sequential path's
    reduce: its input is one chunk holding every pair, and each cluster's
    pairs reach the kernel in the same relative order as in the pipelined
    walk, so both paths agree bit for bit.
    """
    if reduce_op != "sum":
        return _segment_reduce(rc, rv, rm, num_clusters, reduce_op)
    with spans.stage("phase_b.rank_sort"):
        order, rank_sorted = _rank_order(rc, rm, rank_of_cluster, num_clusters)
    out_by_rank, counts_by_rank = fused_ops.fused_shuffle_reduce(
        rv, order, rank_sorted, num_clusters)
    by_cluster = rank_of_cluster.long()
    return out_by_rank[:, by_cluster], counts_by_rank[:, by_cluster]


def _reduce_kept(kept: _Kept, seg, rank_of_cluster, assignment, reduce_op: str):
    """The "run" of one chunk of a :class:`_Kept` spill, every slot at once.

    ``seg`` is the chunk's segment row (:func:`_copy_chunk`). ``sum``:
    kernel 2 gathers each kept pair straight from the Map output through
    ``kept.order``; its sums depend only on each segment's rows in stream
    order, which are those a bucket file gives it, so the bits are the
    same. ``max`` / ``count``: :func:`_segment_reduce` over the chunk's
    pairs by rank. Results are un-permuted to cluster ids and put on the
    row of each cluster's slot (a ``where``, so a value that is not a
    number stays on its own row), ``(rows, n, V)`` and ``(rows, n)`` as
    :func:`_reduce_chunk` gives them.
    """
    n = kept.num_clusters
    if reduce_op == "sum":
        out, counts = fused_ops.fused_shuffle_reduce(kept.values, kept.order, seg, n)
    else:
        out, counts = _segment_reduce(seg, kept.values, (seg >= 0) & (seg < n), n, reduce_op)
    by_cluster = rank_of_cluster.long()
    mine = assignment.long() == kept.me[:, None]
    return (torch.where(mine[..., None], out[:, by_cluster], 0),
            torch.where(mine, counts[:, by_cluster], 0))


def _reduce_received(send, recv, plan, num_clusters: int, reduce_op: str):
    """The reduce of chunk ``recv`` of the spill ``send`` on the exact wire,
    in either form: a :class:`_Kept` spill's segment row, or the ``(rv, rc,
    rm)`` buckets a slot received. ``plan`` is ``(assignment,
    rank_of_cluster, chunk_of_cluster)`` on the rows' device."""
    assignment, rank_of_cluster, _ = plan
    if isinstance(send, _Kept):
        return _reduce_kept(send, recv, rank_of_cluster, assignment, reduce_op)
    return _reduce_chunk(*recv, rank_of_cluster, num_clusters, reduce_op)


def _wire_payload_dtype(quantize: Optional[str], value_dtype: torch.dtype) -> torch.dtype:
    """The dtype the shuffle wire carries: int8, fp8 as its uint8 bit
    patterns (every PyTorch op that moves data takes uint8), or the values'."""
    if quantize == "int8":
        return torch.int8
    if quantize == "fp8":
        return torch.uint8
    return value_dtype


def _quantize_magnitude(values, valid) -> torch.Tensor:
    """The largest valid magnitude of these rows, a float32 device scalar:
    what each slot contributes to the reference's ``pmax``."""
    return (values.float().abs() * valid.float()[..., None]).amax()


def _quantize_scale(values, valid, quantize: Optional[str], magnitude=None):
    """One global int8 scale a batch: the largest valid magnitude over every
    slot (the reference's ``pmax``) over 127, a float32 device scalar.

    ``magnitude`` is that maximum when the rows hold only some slots (the
    sharded backend's pmax); stacked rows hold every slot. A single scale,
    not one a chunk, so that the sequential and pipelined engines encode
    alike and stay bit-identical to each other.
    """
    if quantize != "int8":
        return None
    mag = _quantize_magnitude(values, valid) if magnitude is None else magnitude
    return mag.clamp_min(1e-12) / 127.0


def _quantize_encode(values, scale, quantize: str) -> torch.Tensor:
    """Values → wire payload: symmetric int8, or fp8 e4m3fn bits as uint8.

    The fp8 cast follows the reference's bits: magnitudes above 464 and
    +-inf become a NaN of the value's sign (bytes 0x7f / 0xff) first,
    where PyTorch's cast alone would saturate them to +-448.
    """
    x = values.float()
    if quantize == "int8":
        return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    x = torch.where(x.abs() > _FP8_NAN_ABOVE, torch.copysign(torch.full_like(x, torch.nan), x), x)
    return x.to(_FP8).view(torch.uint8)


def _quantize_decode(q, scale, value_dtype: torch.dtype, quantize: str) -> torch.Tensor:
    """Wire payload → delivered values (deterministic: one scale, one cast)."""
    if quantize == "int8":
        return (q.float() * scale).to(value_dtype)
    return q.view(_FP8).float().to(value_dtype)


def _quantize_wire(values, valid, quantize: Optional[str], magnitude=None):
    """``(scale, wire payload, delivered values, inexact)`` of a batch.

    ``inexact`` counts the valid records whose round trip changed them (a
    device scalar). Without quantization the wire carries the values.
    ``magnitude`` as in :func:`_quantize_scale`.
    """
    if not quantize:
        return None, values, values, torch.zeros((), dtype=torch.int64, device=values.device)
    scale = _quantize_scale(values, valid, quantize, magnitude)
    wire = _quantize_encode(values, scale, quantize)
    delivered = _quantize_decode(wire, scale, values.dtype, quantize)
    inexact = (valid & (delivered != values).any(dim=-1)).sum()
    return scale, wire, delivered, inexact


def _send_caps(static) -> Tuple[int, ...]:
    """Each chunk's capacity a (sender, receiver) group: the plan's chunk
    caps, or one chunk of ``capacity`` when phase B is sequential."""
    (_, _, capacity, chunk_caps, _, pipelined, num_chunks, _) = static
    return tuple(chunk_caps) if pipelined and num_chunks > 1 else (capacity,)


def _bucket_rows(static, rows: int, k: int) -> int:
    """Rows that the spill of ``rows`` slots of ``k`` pairs lays out and
    sorts for the reduce, from shapes: each pair once where the rows hold
    every slot (:class:`_Kept`), else the padded bucket file, one group a
    (row, chunk, receiver) at the chunk's cap."""
    m = static[0]
    return rows * k if rows == m else rows * m * sum(_send_caps(static))


def _spill(intermediate, assignment, rank_of_cluster, chunk_of_cluster, static, me,
           send_vals, deliv_vals):
    """Phase B's spill: every chunk's pairs of these rows in one sort.

    Groups are ``(chunk, dest)`` pairs with statistics-derived capacities,
    which decide the pairs kept: each group's first pairs in stream order
    (drop-newest). The form follows the rows:

    * Rows that hold every slot (``rows == m``: the stacked backend) need
      no static buckets, since no copy leaves the device. The spill keeps
      the kept pairs as indices into the Map output, ``deliv_vals`` (the
      delivered values), and for ``sum`` stable-sorts them by (chunk,
      rank) once: ``send`` is a :class:`_Kept`.
    * Otherwise (one slot a device) every chunk's bucket file is laid out
      chunk-major, so each chunk's send buckets are a contiguous slab of
      the wire payload ``send_vals``, as a copy between devices takes it:
      ``send[c]`` is chunk ``c``'s ``(bv (rows, m, cap, V), bc (rows, m,
      cap), bm (rows, m, cap))`` buckets.

    Returns ``(send, overflow, wire_rows)``, the other two device scalars
    over these rows (``wire_rows``: the kept pairs whose slot is not their
    sender's).
    """
    (m, n, _, _, reduce_op, _, _, _) = static
    key_hashes, _, valid = intermediate
    rows, k = key_hashes.shape
    caps = _send_caps(static)
    cluster_ids = _cluster_ids(key_hashes, n)
    flat_ids = cluster_ids.view(-1)
    group_of_cluster = (chunk_of_cluster * m + assignment if len(caps) > 1 else assignment)
    group = torch.where(valid, group_of_cluster.index_select(0, flat_ids).view(rows, k),
                        len(caps) * m)
    group_caps = np.repeat(np.asarray(caps, np.int64), m)
    if rows == m:
        kept, kept_of, overflow = _kept_places(group, group_caps)
        # Group g's receiver is g % m: the pairs a row keeps for its own
        # slot cross no wire.
        dest = torch.arange(len(group_caps), device=group.device) % m
        wire_rows = torch.where(dest != me[:, None], kept_of, 0).sum()
        span = n + 1
        key_of_cluster = (chunk_of_cluster * span + rank_of_cluster if len(caps) > 1
                          else rank_of_cluster).to(_key_dtype(len(caps) * span))
        keys = torch.where(kept, key_of_cluster.index_select(0, flat_ids).view(rows, k),
                           len(caps) * span).view(1, rows * k)
        sort = None
        if reduce_op == "sum":
            with spans.stage("phase_b.rank_sort"):
                keys, sort = torch.sort(keys[0], stable=True)
                keys, sort = keys[None], sort.to(torch.int32)[None]
        values = deliv_vals.reshape(1, rows * k, deliv_vals.shape[-1])
        return _Kept(values, keys, sort, me, n), overflow, wire_rows
    total = int(group_caps.sum())
    fv, fc, fm, overflow = _ragged_counting_sort_to_buckets(
        group, send_vals, cluster_ids, group_caps, total)
    send = []
    wire_rows = torch.zeros((), dtype=torch.int64, device=send_vals.device)
    off = 0
    for cap in caps:
        size = m * cap
        slab_m = fm[:, off:off + size].reshape(rows, m, cap)
        send.append((fv[:, off:off + size].reshape(rows, m, cap, fv.shape[-1]),
                     fc[:, off:off + size].reshape(rows, m, cap), slab_m))
        wire_rows = wire_rows + _wire_rows(slab_m, me)
        off += size
    return send, overflow, wire_rows


def _tick_pairs(boundaries) -> torch.Tensor:
    """Boundary stamps ``b_0 .. b_W`` ((2,) uint32 each) → the ``(W, 2, 2)``
    ``(start, end) × (lo, hi)`` words of the W waves, as int32 (the same
    bits): wave ``c`` is ``(b_c, b_{c+1})``."""
    b = torch.stack([w.view(torch.int32) for w in boundaries])
    return torch.stack([b[:-1], b[1:]], dim=1)


def _phase_b_body(intermediate, assignment, rank_of_cluster, chunk_of_cluster, static,
                  me, stamp_through=None):
    """Chunked shuffle ("copy") + pipelined reduce ("run") — §4.1 step 6 + §4.4.

    The program of the slots ``me`` (one a row of ``intermediate``): all
    of them on the stacked backend, one on the sharded backend. A
    generator: it yields at each collective and its runner sends back the
    result —

    * ``("pmax", x)`` → the maximum of ``x`` over every slot (the int8
      wire's scale);
    * ``("spill", send)`` → ``None``: every chunk's spilled pairs, as
      :func:`_spill` returns them, are ready;
    * ``("copy", c)`` → this slot's received chunk ``c``: bucket ``[src,
      me]`` of every sender in sender order, ``(rv, rc, rm)``; or, where
      the rows hold every slot and ``send`` is a :class:`_Kept`, the
      chunk's segment row (:func:`_copy_chunk`).

    ``pipelined=False`` (or a single chunk) is the Hadoop-style barrier:
    one bulk all-to-all of every pair, then one reduce. The pipelined path
    spills every chunk's pairs at once and walks the chunks in
    increasing-load order, issuing the copy of chunk ``c+1`` before the
    reduce of chunk ``c`` — the reference's double-buffered order. A
    quantized wire spills and copies the encoded payload and decodes each
    received chunk; a :class:`_Kept` spill holds the delivered values.

    ``stamp_through`` is the measured executor's tick hook
    (``kernels/wave_timer.ops.stamp_through``): when set, per-wave
    boundary stamps are threaded through THIS body — the stamp before
    each reduce produces the ids the reduce reads (``rc``, or the segment
    row), the final one re-emits the last wave's outputs — and ``(W, 2,
    2)`` tick words are appended to the result. ``None`` runs the
    identical untimed program, so measured and unmeasured runs agree bit
    for bit by construction. On one stream a slot's copy of a later chunk
    falls inside the wave in whose interval it is enqueued; every wave is
    the slot's own stream time.

    Returns ``(out (rows, n, V), counts (rows, n), overflow, wire[,
    ticks])``, device tensors over these rows: the overflow count and the
    int64 ``[wire_rows, replica_rows, inexact, nonlocal_pairs]`` vector.
    """
    (m, n, capacity, chunk_caps, reduce_op, pipelined, num_chunks, quantize) = static
    _, values, valid = intermediate
    rows, v_dim = values.shape[0], values.shape[-1]
    timed = stamp_through is not None
    magnitude = None
    if quantize == "int8":
        magnitude = yield ("pmax", _quantize_magnitude(values, valid))
    with spans.stage("phase_b.spill"):
        scale, send_vals, deliv_vals, inexact = _quantize_wire(values, valid, quantize,
                                                               magnitude)
        send, overflow, wire_rows = _spill(intermediate, assignment, rank_of_cluster,
                                           chunk_of_cluster, static, me, send_vals, deliv_vals)
    kept = send if isinstance(send, _Kept) else None

    def _reduce(recv, *anchors):
        """One received chunk's reduce, and the stamp its ids passed when
        timed (``None`` untimed)."""
        stamp = None
        if kept is not None:
            if timed:
                recv, stamp = stamp_through(recv, *anchors)
            return _reduce_kept(kept, recv, rank_of_cluster, assignment, reduce_op), stamp
        rv, rc, rm = recv
        if quantize:
            rv = _quantize_decode(rv, scale, values.dtype, quantize)
        if timed:
            rc, stamp = stamp_through(rc, *anchors)
        return _reduce_chunk(rv, rc, rm, rank_of_cluster, n, reduce_op), stamp

    def _wire(wire_rows):
        return torch.stack([wire_rows, torch.zeros_like(wire_rows), inexact, wire_rows])

    yield ("spill", send)
    del send

    if not pipelined or num_chunks <= 1:
        recv = yield ("copy", 0)
        with spans.stage("phase_b.reduce"):
            (out, counts), start = _reduce(recv)       # start: produces the reduce's ids
            if timed:
                out, end = stamp_through(out, counts)  # end: re-emits the outputs
        if timed:
            return out, counts, overflow, _wire(wire_rows), _tick_pairs([start, end])
        return out, counts, overflow, _wire(wire_rows)

    # ---- Copy→run walk in increasing-load chunk order. Sums accumulate in
    # float32 (the fused kernel's output), max/count in the value dtype.
    # Timed: boundary stamps b_0..b_C, b_c between reduce(c-1) and
    # reduce(c); the final one after the last reduce.
    acc_dtype = torch.float32 if reduce_op == "sum" else values.dtype
    acc = torch.zeros((rows, n, v_dim), dtype=acc_dtype, device=values.device)
    cnt = torch.zeros((rows, n), dtype=torch.float32, device=values.device)
    boundaries = []
    prev_out = ()
    recv = yield ("copy", 0)
    for c in range(num_chunks):
        chunk = recv
        if c + 1 < num_chunks:
            recv = yield ("copy", c + 1)
        with spans.stage("phase_b.reduce"):
            (out_c, cnt_c), b = _reduce(chunk, *prev_out)
            if timed:
                boundaries.append(b)
            if timed and c + 1 == num_chunks:
                out_c, b = stamp_through(out_c, cnt_c)
                boundaries.append(b)
            prev_out = (out_c, cnt_c)
            acc, cnt = _merge_chunk(acc, cnt, out_c, cnt_c, reduce_op)
    if timed:
        return acc, cnt, overflow, _wire(wire_rows), _tick_pairs(boundaries)
    return acc, cnt, overflow, _wire(wire_rows)


def _drive_stacked(body):
    """Run a phase-B body over all m stacked slots.

    Every collective is local: the rows already hold every slot, so
    ``pmax`` is the value itself, the copy of a chunk is its segment row
    over the spill's kept pairs (:func:`_copy_chunk`), and the coded
    body's replica and packet exchanges are transposes of their ``(src,
    dst, ...)`` axes.
    """
    send = reply = None
    while True:
        try:
            kind, arg = body.send(reply)
        except StopIteration as stop:
            return stop.value
        if kind == "pmax":
            reply = arg
        elif kind == "spill":
            send, reply = arg, None
        elif kind == "copy":
            reply = _copy_chunk(send, arg)
        elif kind == "replicas":
            reply = tuple(_transpose_slots(t) for t in arg)
        else:   # packets
            reply = _transpose_slots(arg)


def _transpose_slots(x: torch.Tensor) -> torch.Tensor:
    """The stacked all-to-all: ``(src, dst, ...)`` → ``(dst, src, ...)``."""
    return x.transpose(0, 1).contiguous()


def _merge_chunk(acc, cnt, out_c, cnt_c, reduce_op: str):
    """Fold one chunk's reduce into the accumulators.

    Every cluster lives in exactly one chunk, so merging is a *replace*
    where this chunk saw data — correct for max (a maximum() merge would
    clamp negative maxima at the zero init) and equivalent to += for
    sum/count (``out_c`` is 0 elsewhere).
    """
    if reduce_op == "max":
        acc = torch.where(cnt_c[..., None] > 0, out_c.to(acc.dtype), acc)
    else:
        acc = acc + out_c.to(acc.dtype)
    return acc, cnt + cnt_c


def _phase_b_coded(intermediate, assignment, rank_of_cluster, chunk_of_cluster, static,
                   slots):
    """Coded phase B: r=2 pair placement + XOR multicast (arXiv 1512.01625).

    The coded execution of the same §4.4 chunk walk. Record ``j`` of slot
    ``s`` is *pair-placed* on ``{s, π(s, j)}`` with partner ``π(s, j) = (s
    + 1 + (j mod (m−1))) mod m``: every slot holds a replica of ``1/(m−1)``
    of each other slot's records, the coded analogue of running each map
    shard on two nodes. The replicas arrive by an exchange whose rows are
    accounted apart (``replication_bytes``), a stand-in for the storage
    replication or redundant map work that the scheme assumes.

    The shuffle then sends one XOR **multicast packet** per slot pair
    ``{d, q}`` instead of two unicast slabs: sender ``s`` XORs its
    (partner=d → dst=q) slab with its (partner=q → dst=d) slab word by word
    (:func:`~repro_torch.kernels.coded_shuffle.ops.encode_packets`). Receiver
    ``d`` rebuilds the first slab from its replicas with the *identical*
    stable counting sort and XORs it out, which leaves the slab addressed
    to it, bit for bit. Pairs whose partner is their destination arrive
    with the replicas, so wire rows shrink by up to ``2(m−1)/(m−2)``.

    Bit-identity with the uncoded engine: each slab row carries the sender
    record index ``j`` and the cluster id beside the packed value words;
    the receiver re-orders every delivered pair by ``(src, j)`` — the
    uncoded stream's per-cluster order — and feeds the same per-chunk
    :func:`_reduce_chunk`. Invalid rows are all-zero words (XOR-neutral)
    and masked out.

    The program of the consecutive slots ``slots`` (one a row of
    ``intermediate``): all m on the stacked backend, one on the sharded
    backend. A generator like :func:`_phase_b_body`, which yields at each
    collective —

    * ``("pmax", x)`` → the maximum of ``x`` over every slot (int8 scale);
    * ``("replicas", (kh, v, ok))`` → the replica exchange: each tensor is
      ``(rows, partner, ...)`` and comes back ``(rows, src, ...)``, what
      every sender sent to these rows;
    * ``("packets", x)`` → one chunk's packet exchange: ``(rows, dst, ...)``
      out, ``(rows, src, ...)`` back.

    Both ragged spills run over these rows' records as one stream with the
    row inside the chunk-major group id — ``(chunk, row, partner | src,
    dst)`` — so each chunk's slab is one contiguous block, as the encode
    kernel takes it, and a slot holds only its own m² groups a chunk.
    Returns what :func:`_phase_b_body` returns; ``wire`` holds the packet
    rows (each multicast once), the replica rows, the inexact records and
    the non-local pairs.
    """
    (m, n, capacity, chunk_caps, reduce_op, pipelined, num_chunks, quantize) = static
    key_hashes, values, valid = intermediate
    dev = values.device
    rows, k, v_dim = values.shape
    v_dtype = values.dtype
    me = torch.arange(slots[0], slots[0] + rows, device=dev)[:, None]   # each row's slot
    ridx = torch.arange(rows, device=dev)[:, None]
    cluster_ids = _cluster_ids(key_hashes, n)
    cid = cluster_ids.long()
    dest = assignment[cid].long()
    if pipelined and num_chunks > 1:
        chunks, caps = num_chunks, tuple(chunk_caps)
        chunk_of_pair = chunk_of_cluster[cid].long()
    else:
        chunks, caps = 1, (capacity,)
        chunk_of_pair = torch.zeros_like(cid)
    # Replica rows a (src, partner): each partner offset is hit every m−1
    # records, so ⌈K/(m−1)⌉ bounds every (chunk, partner, dst) group.
    n_rep = -(-k // (m - 1))
    cap2 = tuple(int(min(n_rep, c)) for c in caps)
    tt = torch.arange(n_rep, device=dev) * (m - 1)

    # ---- Quantized wire payload (optional): one global scale, so sender,
    # replica holder and receiver encode a record to the same bits.
    magnitude = None
    if quantize == "int8":
        magnitude = yield ("pmax", _quantize_magnitude(values, valid))
    scale, wire_vals, deliv_vals, inexact = _quantize_wire(values, valid, quantize, magnitude)
    pay_dtype = _wire_payload_dtype(quantize, v_dtype)
    w_pay = cs_ops.packed_width(v_dim, pay_dtype)
    w_row = w_pay + 2        # + cluster_id+1 word, + j+1 word (0 = invalid)
    jidx = torch.arange(k, device=dev, dtype=torch.int32).expand(rows, k)
    aug = torch.cat([cs_ops.pack_payload_words(wire_vals), (cluster_ids + 1)[..., None],
                     (jidx + 1)[..., None]], dim=2)

    # ---- r=2 replica exchange: slot p receives the records j of slot s
    # with π(s, j) == p, i.e. j ≡ (p − s − 1) (mod m−1) — a strided slice.
    ofs = (torch.arange(m, device=dev) - me - 1) % m          # (row, partner)
    sidx = ofs[..., None] + tt                                # (row, partner, n_rep)
    smask = (sidx < k) & (ofs < m - 1)[..., None]             # partner == src: none
    pick = sidx.clamp(max=k - 1).reshape(rows, -1)
    send_kh = torch.where(smask, key_hashes.gather(1, pick).view(rows, m, n_rep), 0)
    send_v = torch.where(smask[..., None], values.gather(
        1, pick[..., None].expand(rows, m * n_rep, v_dim)).view(rows, m, n_rep, v_dim), 0)
    send_ok = smask & valid.gather(1, pick).view(rows, m, n_rep)
    del sidx, smask, pick
    r_kh, r_v, r_ok = yield ("replicas", (send_kh, send_v, send_ok))
    del send_kh, send_v, send_ok
    # Record j of src s reached me at offset (me − s − 1) mod m.
    r_j = (((me - torch.arange(m, device=dev) - 1) % m)[..., None] + tt).to(torch.int32)
    rows_rep = r_ok.sum()
    r_cluster = _cluster_ids(r_kh, n)
    r_dest = assignment[r_cluster.long()].long()
    r_chunk = (chunk_of_cluster[r_cluster.long()].long() if chunks > 1
               else torch.zeros_like(r_dest))
    r_wire = _quantize_encode(r_v, scale, quantize) if quantize else r_v
    r_aug = torch.cat([cs_ops.pack_payload_words(r_wire), (r_cluster + 1)[..., None],
                       (r_j + 1)[..., None]], dim=3)
    del r_kh, r_v, r_wire

    # ---- Two ragged spills with the same group layout. Sender side: my
    # records by (chunk, row, partner, dst), dst ≠ me — the packets' XOR
    # terms. Replica side: received replicas by (chunk, row, src, dst) —
    # bit-equal rebuilds of each src's (partner=me, dst) slabs (same stable
    # sort, same caps, same j order), which open the packets; their dst=me
    # column carries the pairs the replicas deliver.
    groups = chunks * rows * m * m
    caps2_np = np.repeat(np.asarray(cap2, np.int64), rows * m * m)
    total2 = int(caps2_np.sum())
    partner = (me + 1 + jidx % (m - 1)) % m
    gid = torch.where(valid & (dest != me),
                      ((chunk_of_pair * rows + ridx) * m + partner) * m + dest,
                      groups).to(torch.int32)
    s_aug, _, s_bm, ovf_send = _ragged_counting_sort_to_buckets(
        gid.reshape(1, -1), aug.reshape(1, rows * k, w_row), cluster_ids.reshape(1, -1),
        caps2_np, total2)
    del aug, gid
    src = torch.arange(m, device=dev)[:, None]
    r_gid = torch.where(r_ok, ((r_chunk * rows + ridx[..., None]) * m + src) * m + r_dest,
                        groups).to(torch.int32)
    k_aug, _, _, ovf_rep = _ragged_counting_sort_to_buckets(
        r_gid.reshape(1, -1), r_aug.reshape(1, -1, w_row), r_cluster.reshape(1, -1),
        caps2_np, total2)
    del r_aug, r_gid

    # ---- Pairs a slot both holds and reduces (dst == me): delivered
    # locally with the decoded value and the same j tag. (A float32
    # carrier is exact for f32/bf16 payloads and for j < 2^24.)
    caps_own = np.asarray(caps, np.int64)
    total_own = int(caps_own.sum())
    gid_own = torch.where(valid & (dest == me), chunk_of_pair, chunks).to(torch.int32)
    own_carrier = torch.cat([deliv_vals.float(), jidx.float()[..., None]], dim=2)
    o_vals, o_bc, o_bm, ovf_own = _ragged_counting_sort_to_buckets(
        gid_own, own_carrier, cluster_ids, caps_own, total_own)
    del own_carrier

    # ---- Per-chunk packets X[s, d, q] = S[s, p=d→q] ⊕ S[s, p=q→d], one
    # multicast per unordered pair {d, q} (both copies carry the same
    # packet; accounted once below), zero where there is no pair: one
    # launch of the encode instance a chunk.
    ids = torch.arange(m, device=dev)
    a0, a1, a2 = me[..., None], ids[None, :, None], ids[None, None, :]
    pair_ok = (a1 != a2) & (a1 != a0) & (a2 != a0)       # (row, d, q)
    send_pkts = []
    wire_rows = torch.zeros((), dtype=torch.int64, device=dev)
    off = 0
    for c in range(chunks):
        size = rows * m * m * cap2[c]
        slab = s_aug[0, off:off + size].view(rows, m, m, cap2[c], w_row)
        send_pkts.append(cs_ops.encode_packets(slab, first_sender=slots[0]))
        # Packet {d, q} rows = the larger of its two slabs; each unordered
        # pair appears twice in the ordered sum, hence the halving.
        cnt = s_bm[0, off:off + size].view(rows, m, m, cap2[c]).sum(dim=3)
        wire_rows = wire_rows + torch.where(
            pair_ok, torch.maximum(cnt, cnt.transpose(1, 2)), 0).sum() // 2
        off += size
    del s_aug, s_bm, slab
    pairs_nonlocal = (valid & (dest != me)).sum()

    # ---- Double-buffered decode → reduce walk (the §4.4 shape: chunk
    # c+1's packet exchange is issued before chunk c's reduce).
    acc_dtype = torch.float32 if reduce_op == "sum" else v_dtype
    acc = torch.zeros((rows, n, v_dim), dtype=acc_dtype, device=dev)
    cnt_acc = torch.zeros((rows, n), dtype=torch.float32, device=dev)
    big = torch.iinfo(torch.int64).max
    # A decoded row (me, src, q) counts when src ≠ me and it is either a
    # packet from a pair (q ≠ src) or the replica-delivered column q == me.
    d_ok_static = ((a1 != a0) & ((a2 == a0) | (a2 != a1)))[..., None]
    src_of_row = a1[..., None]
    off = own_off = 0
    recv = yield ("packets", send_pkts[0])
    send_pkts[0] = None
    for c in range(chunks):
        rx = recv
        if c + 1 < chunks:
            recv = yield ("packets", send_pkts[c + 1])
            send_pkts[c + 1] = None
        size = rows * m * m * cap2[c]
        # One XOR opens everything: for q ≠ me the packet minus my rebuilt
        # slab leaves src's (partner=q → me) slab; the q == me column has no
        # packet (zeros), so my replica-delivered (partner=me → me) slab
        # passes straight through.
        dec = cs_ops.xor_words(rx.view(size, w_row), k_aug[0, off:off + size])
        del rx
        dec = dec.view(rows, m, m, cap2[c], w_row)
        meta = dec[..., w_pay]
        d_ok = ((meta > 0) & d_ok_static).reshape(rows, -1)
        d_vals = cs_ops.unpack_payload_words(dec[..., :w_pay], pay_dtype, v_dim)
        d_vals = (_quantize_decode(d_vals, scale, v_dtype, quantize) if quantize
                  else d_vals).reshape(rows, -1, v_dim)
        d_cl = (meta - 1).reshape(rows, -1)
        d_key = (src_of_row * k + dec[..., w_pay + 1] - 1).reshape(rows, -1)
        del dec, meta

        own = o_vals[:, own_off:own_off + caps[c]]
        own_key = me * k + own[..., v_dim].long()
        sv = torch.cat([own[..., :v_dim].to(v_dtype), d_vals], dim=1)
        scl = torch.cat([o_bc[:, own_off:own_off + caps[c]], d_cl], dim=1)
        sok = torch.cat([o_bm[:, own_off:own_off + caps[c]], d_ok], dim=1)
        skey = torch.cat([own_key, d_key], dim=1)
        own_off += caps[c]
        off += size
        # The uncoded stream orders each cluster's pairs by (src slot,
        # bucket position) = (src, j); restoring exactly that order feeds
        # the same reduce the same sequence → bit-identity. Sender and
        # receiver must break equal keys alike, so the sort is stable.
        order = torch.argsort(torch.where(sok, skey, big), dim=1, stable=True)
        del skey
        with spans.stage("phase_b.reduce"):
            out_c, cnt_c = _reduce_chunk(
                sv.gather(1, order[..., None].expand_as(sv)), scl.gather(1, order),
                sok.gather(1, order), rank_of_cluster, n, reduce_op)
            del sv, scl, sok, order
            if chunks == 1:
                # As the uncoded sequential branch: the reduce output is the
                # result (shape included — count yields (rows, n, 1)).
                acc, cnt_acc = out_c, cnt_c
            else:
                acc, cnt_acc = _merge_chunk(acc, cnt_acc, out_c, cnt_c, reduce_op)

    overflow = ovf_send + ovf_rep + ovf_own
    wire = torch.stack([wire_rows, rows_rep, inexact, pairs_nonlocal])
    return acc, cnt_acc, overflow, wire


# ---------------------------------------------------------------------------
# The job orchestrator.
# ---------------------------------------------------------------------------


class MapReduceJob:
    """Two-phase OS4M job on one or more devices. See the module docstring.

    ``map_fn(inputs) -> (key_hashes (r, K), values (r, K, V), valid (r,
    K))`` returns stacked tensors for the ``r`` slots of its input.

    ``backend="stacked"``: ``map_fn`` sees all ``m`` slots at once and
    returns tensors on ``device``. ``device=None`` means ``"cuda"`` and
    raises when no CUDA device is present; pass ``device="cpu"`` to run
    the kernels' plain versions on the CPU.

    ``backend="sharded"``: ``devices`` holds one device per slot (the
    counterpart of the reference's mesh; the same device may repeat).
    ``None`` means ``m`` copies of the current CUDA device and raises when
    there is none; ``["cpu"] * m`` runs the plain versions. Every CUDA
    slot gets its own stream. ``map_fn`` runs per slot on the ``(1, ...)``
    slice of every tensor of ``inputs`` (a tensor, or tuples, lists and
    dicts of them, with a leading ``(m,)`` axis), on that slot's device
    and stream.

    ``trace=True`` records the spans inside every run (as a running
    ``torch.profiler`` does): ``last_spans``, and a key a span in
    ``last_phase_ms`` (:mod:`repro_torch.core.spans`).
    """

    def __init__(self, map_fn: Callable, config: MapReduceConfig, device=None,
                 backend: str = "stacked", devices=None, trace: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
        self.backend = backend
        if backend == "sharded":
            if device is not None:
                raise ValueError(
                    "backend='sharded' places its slots with devices=, not device=")
            self._init_slots(devices, config.num_slots)
        else:
            if devices is not None:
                raise ValueError("devices= places the slots of backend='sharded'")
            self.device = default_device(device, "MapReduceJob")
            self.devices = self.streams = None
        self.map_fn = map_fn
        self.cfg = config
        self.trace = trace
        self._spans = spans.Spans()
        self._measure_timings = _resolve_measure(config, backend)
        _validate_wire(config, self._measure_timings)
        if config.reduce_op not in REDUCE_OPS:
            raise ValueError(
                f"unknown reduce_op {config.reduce_op!r}; use one of {REDUCE_OPS}")
        # Statistics provider: owns phase A's collection step and the
        # host-side estimators _plan reads.
        self._stats = sp.make_provider(
            config.stats, config.num_clusters,
            width=config.sketch_width, depth=config.sketch_depth)
        if config.stream_prefix is not None:
            if config.stats != "sketch":
                raise ValueError(
                    "stream_prefix requires stats='sketch' — prefix planning"
                    " extrapolates a sketch, the exact path has no estimate"
                    " to extrapolate")
            if not 0.0 < config.stream_prefix <= 1.0:
                raise ValueError(
                    f"stream_prefix must be in (0, 1], got {config.stream_prefix}")
        if config.stats == "sketch" and config.checkpoint_waves:
            raise ValueError(
                "stats='sketch' is incompatible with checkpoint_waves — "
                "wave recovery zeroes completed per-cluster histogram "
                "columns, which a count-min counter grid does not have")
        # Overflow escape hatches taken for estimate-committed capacities
        # (prefix-planned wave-1 caps; see _escalate_caps). Distinct from
        # ScheduleCache.capacity_fallbacks, which counts reused-plan
        # overflows.
        self.capacity_fallbacks = 0
        # Schedule-reuse state: the live CachedSchedule snapshot and the
        # decision counters when cfg.reuse is set. On the sharded backend
        # the drift check runs next to each slot's statistics.
        self.schedule_cache: Optional[sc.ScheduleCache] = (
            sc.ScheduleCache(config.reuse, drift_fn=self._make_sharded_drift())
            if config.reuse is not None else None)
        # Q||C_max state: static speeds are validated once; the online
        # estimator closes the measure → update → next-plan feedback loop.
        if config.speeds is not None:
            sched_lib.normalize_speeds(config.speeds, config.num_slots)
        self.speed_estimator: Optional[ss.SlotSpeedEstimator] = (
            ss.SlotSpeedEstimator(config.num_slots, ewma=config.speed_ewma)
            if config.estimate_speeds else None)
        # Last batch's measured (slots, waves) timings (None on the
        # synthetic path) — telemetry for benches and tests.
        self.last_wave_timings: Optional[mt.WaveTimings] = None
        # Fault injection: per-slot wall-clock multipliers (2.0 = twice as
        # slow). The stacked backend synthesises wave timings as work ×
        # slowdown; the sharded backend's measured path scales the measured
        # seconds instead. Callers with their own clocks feed
        # observe_slot_times directly.
        self._slot_slowdown = np.ones(config.num_slots)
        # True once observe_slot_times delivered a real measurement; the
        # synthetic model then stays out of the estimator.
        self._external_timings = False
        # Last measured (wire bytes, non-local pairs): turns the cost
        # model's modeled bytes/pair into a measured rate on the next plan.
        self._last_wire: Optional[Tuple[int, int]] = None
        # Milliseconds of the last run(). Always the host clock of its
        # three phases: "phase_a" (map + statistics + the reuse decision,
        # ending with the pull of the statistics the host needs), "plan"
        # (cost gate and host scheduler; ~0 on a reused batch), "phase_b"
        # (shuffle + reduce, with any overflow re-plan and re-execution,
        # ending with the output pull). Each phase ends in a device→host
        # copy, so on CUDA the device work is inside its phase. With spans
        # on (trace=True, or a profiler recording), also one key a span
        # inside them, "phase_a.map_stats" ... "phase_b.pull": the
        # stream's elapsed ms over a device stage (the card's idle inside
        # it included), host ms of a host span. last_spans holds the run's
        # span records then, and is empty with spans off.
        self.last_phase_ms: Optional[dict] = None
        self.last_spans: list = []
        # The rows phase B laid out in the run in progress: JobResult.bucket_rows.
        self._run_bucket_rows: Optional[int] = None
        # The plan the last run() executed (telemetry for benches and tests).
        self.last_plan: Optional[sc.CachedSchedule] = None
        # Elastic-mesh state: which slots have vanished (speed pinned to
        # exact 0.0 — the dead-slot convention of ``scheduler.
        # normalize_speeds``), and armed mid-batch kills (slot → wave
        # index; fired by the checkpointing executor just before that
        # wave runs). ``on_mesh_change(event_dict)`` is an optional
        # observer hook; ``mesh_events`` keeps the full join/leave/death
        # log either way.
        self._dead_slots = np.zeros(config.num_slots, dtype=bool)
        self._kill_at_wave: dict = {}
        self.on_mesh_change: Optional[Callable[[dict], None]] = None
        self.mesh_events: list = []
        # Checkpoint telemetry of the last run() (None before the first
        # checkpointed batch): wave cursor at the last completed
        # checkpoint, how many waves the recovery replayed (0 = clean
        # uninterrupted batch), and the WaveCheckpoint itself.
        self.last_checkpoint_wave: Optional[int] = None
        self.last_replayed_waves: Optional[int] = None
        self.last_checkpoint: Optional[pipe.WaveCheckpoint] = None
        # The recovery plan of the last mid-batch failure (None if the
        # last batch ran clean): its schedule assigns the dead slots no
        # load.
        self.last_replay_plan: Optional[sc.CachedSchedule] = None

    def _init_slots(self, devices, num_slots: int) -> None:
        """One device and (on CUDA) one stream per slot of the sharded backend."""
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend='sharded' places every slot on the current CUDA device"
                    " unless told otherwise, and no CUDA device is available; pass"
                    " devices=['cpu'] * num_slots for the CPU path")
            devices = [None] * num_slots
        devices = [default_device(d, "MapReduceJob") for d in devices]
        if len(devices) != num_slots:
            raise ValueError(
                f"devices has {len(devices)} entries but config.num_slots={num_slots}")
        if len({d.type for d in devices}) != 1:
            raise ValueError("the slots' devices must all be CUDA or all be the CPU")
        self.devices = devices
        self.device = devices[0]
        self.streams = [_slot_stream(d, j) if d.type == "cuda" else None
                        for j, d in enumerate(devices)]

    # -- Q||C_max speed plumbing --------------------------------------------

    def set_slot_slowdown(self, slot: int, factor: float) -> None:
        """Inject a fault: slot ``slot``'s wave wall-clock is multiplied by ``factor``.

        A slowdown factor is a **wall-clock multiplier** — ``2.0`` makes
        the slot read twice as *slow* (half the nominal speed); ``0.5``
        makes it read twice as fast. Affects only the wave timings the
        estimator sees (and hence future plans) — never the computed
        outputs.

        ``factor == 0`` is the elastic-mesh limit: the slot is **dead**
        (vanished, not infinitely slow) and the call routes to
        :meth:`set_slot_failure` — future plans assign it nothing at all.
        """
        if not 0 <= slot < self.cfg.num_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.cfg.num_slots})")
        if factor < 0:
            raise ValueError("slowdown factor must be >= 0 (0 = dead slot)")
        if factor == 0:
            self.set_slot_failure(slot)
            return
        self._slot_slowdown[slot] = factor

    def set_slot_failure(self, slot: int, dead: bool = True,
                         at_wave: Optional[int] = None) -> None:
        """Declare slot ``slot`` dead (or revived) on the elastic mesh.

        ``dead=True`` with no ``at_wave`` takes effect immediately: the
        slot's speed is pinned to exact 0.0 in :meth:`current_speeds`, the
        online estimator masks it out (a dead slot never re-inherits
        work), and the next plan — forced by the schedule cache's
        ``"slot_dead"`` structural check — assigns it nothing.

        ``at_wave=w`` arms a **mid-batch kill** for fault injection
        (``launch/serve.py --kill-at-wave i:w``): the slot dies just
        before phase-B wave ``w`` executes, after waves ``0..w-1``
        checkpointed. Requires ``MapReduceConfig(checkpoint_waves=True)``
        — without wave checkpoints there is no consistent cut to recover
        from.

        ``dead=False`` revives a previously dead slot (a join): its speed
        estimate resets to unknown and the next structural check replans.
        """
        if not 0 <= slot < self.cfg.num_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.cfg.num_slots})")
        if at_wave is not None:
            if not dead:
                raise ValueError("at_wave only makes sense with dead=True")
            if not self.cfg.checkpoint_waves:
                raise ValueError(
                    "set_slot_failure(at_wave=...) requires "
                    "MapReduceConfig(checkpoint_waves=True)")
            if at_wave < 0:
                raise ValueError("at_wave must be >= 0")
            self._kill_at_wave[int(slot)] = int(at_wave)
            return
        self._mark_slot_dead(slot, dead)

    def _mark_slot_dead(self, slot: int, dead: bool = True) -> None:
        """Flip one slot's dead bit + estimator mask; emit a mesh event."""
        if bool(self._dead_slots[slot]) == bool(dead):
            return
        self._dead_slots[slot] = dead
        self._kill_at_wave.pop(slot, None)
        if self.speed_estimator is not None:
            self.speed_estimator.set_slot_failure(slot, dead=dead)
        self._emit_mesh_event({
            "event": "slot_dead" if dead else "slot_join",
            "slot": int(slot),
            "num_slots": self.cfg.num_slots,
            "alive": int(self.cfg.num_slots - int(self._dead_slots.sum())),
        })

    def _emit_mesh_event(self, event: dict) -> None:
        """Log a join/leave/death/resize event; notify the observer hook."""
        self.mesh_events.append(event)
        if self.on_mesh_change is not None:
            self.on_mesh_change(event)

    def resize(self, num_slots: int, devices=None) -> None:
        """Elastically resize the mesh to ``num_slots`` Reduce slots.

        The cheap path through a membership change: instead of discarding
        the job's warm state, every per-slot structure is re-shaped —

        * a cached plan snapshot is **re-projected** onto the new slot
          count (``CachedSchedule.reproject``: re-bin the per-shard
          ``K^(i)`` baseline + one host re-plan from those warm
          statistics — no cold statistics pass on the next batch);
        * the speed estimator keeps the surviving slots' learned rates
          (``SlotSpeedEstimator.resize``);
        * slowdown/dead-slot vectors and armed kills are truncated or
          padded (new slots arrive alive and nominal);
        * the sharded drift closure is rebuilt for the new slots (the port
          compiles nothing per shape, so no other cache is keyed on m);
          the re-projected snapshot uploads its baseline once, at the next
          drift check.

        ``devices`` places the slots of ``backend="sharded"`` as the
        constructor's ``devices=`` does (exactly ``num_slots`` entries;
        ``None`` = ``num_slots`` copies of the current CUDA device) — the
        counterpart of the reference's ``mesh``. The stacked backend takes
        none.
        """
        old_m = self.cfg.num_slots
        if num_slots == old_m:
            return
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.backend == "sharded":
            self._init_slots(devices, num_slots)
        elif devices is not None:
            raise ValueError("devices= places the slots of backend='sharded'")

        # Static speeds: keep survivors, pad joiners at nominal.
        new_speeds = None
        if self.cfg.speeds is not None:
            base = list(self.cfg.speeds)[:num_slots]
            base += [1.0] * (num_slots - len(base))
            new_speeds = tuple(base)
        self.cfg = dataclasses.replace(self.cfg, num_slots=num_slots, speeds=new_speeds)

        # Per-slot state: truncate or pad (new slots alive, nominal).
        keep = min(old_m, num_slots)
        slowdown = np.ones(num_slots)
        slowdown[:keep] = self._slot_slowdown[:keep]
        self._slot_slowdown = slowdown
        dead = np.zeros(num_slots, dtype=bool)
        dead[:keep] = self._dead_slots[:keep]
        self._dead_slots = dead
        self._kill_at_wave = {s: w for s, w in self._kill_at_wave.items() if s < num_slots}
        if self.speed_estimator is not None:
            self.speed_estimator.resize(num_slots)

        if self.schedule_cache is not None:
            self.schedule_cache.drift_fn = self._make_sharded_drift()
            snap = self.schedule_cache.snapshot
            if snap is not None:
                # Warm resize: re-project the snapshot instead of going
                # cold — one re-plan from the re-binned K^(i) baseline.
                self.schedule_cache.snapshot = snap.reproject(num_slots, self._plan)
                self.schedule_cache.reprojections += 1
        self._emit_mesh_event({
            "event": "resize",
            "from": int(old_m),
            "to": int(num_slots),
            "alive": int(num_slots - int(self._dead_slots.sum())),
        })

    @property
    def dead_slots(self) -> np.ndarray:
        """Boolean mask of vanished slots (copy)."""
        return self._dead_slots.copy()

    def current_speeds(self) -> Optional[np.ndarray]:
        """Speed vector the next plan will use (None ≡ all nominal).

        Static ``cfg.speeds`` wins; otherwise the online estimate (None
        until the estimator has seen at least one batch). Dead slots
        overlay an exact 0.0 on either source — with neither source set,
        a mesh with dead slots still returns a concrete vector (nominal
        alive, 0.0 dead) so every planner sees the failure.
        """
        if self.cfg.speeds is not None:
            base = np.asarray(self.cfg.speeds, np.float64)
        elif self.speed_estimator is not None:
            base = self.speed_estimator.speeds()
        else:
            base = None
        if np.any(self._dead_slots):
            if base is None:
                base = np.ones(self.cfg.num_slots, np.float64)
            return np.where(self._dead_slots, 0.0, base)
        return base

    def proc_times_row(self, total_load: float = 1.0) -> np.ndarray:
        """This job's row of the multi-job R-matrix: per-slot time for
        ``total_load`` units of its work.

        ``R[job, slot] = total_load / speed[job, slot]`` from the job's
        own speed estimate; a slot of speed 0 reads ``+inf``.
        """
        speeds = self.current_speeds()
        if speeds is None:
            speeds = np.ones(self.cfg.num_slots, np.float64)
        row = np.full(self.cfg.num_slots, np.inf, np.float64)
        alive = speeds > 0.0
        row[alive] = float(total_load) / speeds[alive]
        return row

    def observe_slot_times(self, slot_work, slot_seconds) -> None:
        """Feed measured per-slot phase-B (work, wall seconds) to the estimator.

        The hook for deployments whose slots have their own clocks. The
        first call permanently switches the job to external-measurement
        mode: ``run()`` stops folding in its synthetic timing model, so
        real samples are never diluted by all-nominal synthetic ones.
        """
        if self.speed_estimator is not None:
            self._external_timings = True
            self.speed_estimator.update(slot_work, slot_seconds)

    def _observe_wave_timings(self, planned: sc.CachedSchedule,
                              key_dist: np.ndarray) -> None:
        """Synthetic per-slot timing model: seconds = work × slowdown.

        One observation per executed batch, with the injected
        ``_slot_slowdown`` standing in for straggler hardware. The
        estimator normalises rates, so the nominal unit cancels; with no
        injected fault every slot measures 1.0 and plans stay identical to
        the speed-oblivious ones. Disabled as soon as
        ``observe_slot_times`` has delivered a real measurement.
        """
        if self.speed_estimator is None or self._external_timings:
            return
        m = self.cfg.num_slots
        slot_work = np.bincount(
            planned.schedule.assignment, weights=np.asarray(key_dist),
            minlength=m)[:m]
        slot_seconds = slot_work * self._slot_slowdown
        self.speed_estimator.update(slot_work, slot_seconds)

    def _observe_measured(self, timings: mt.WaveTimings,
                          planned: sc.CachedSchedule) -> None:
        """Feed one batch's *measured* per-slot wave clocks to the estimator.

        Waves are capacity-shaped — every slot reduces the same padded
        buffer — so the work unit is the shape work (rows processed,
        identical per slot) and ``work/seconds`` isolates per-slot speed
        from per-slot load. Injected slowdowns multiply the measured
        seconds. Invalid batches, and batches with no positive finite
        seconds, carry no speed signal and are skipped. Routed through
        :meth:`observe_slot_times`, which retires the synthetic model on
        first contact.
        """
        if self.speed_estimator is None or not timings.valid:
            return
        m = self.cfg.num_slots
        rows = float(m * planned.capacity if planned.waves.num_chunks <= 1
                     else m * sum(planned.chunk_caps))
        timings.slot_work = np.full(m, rows)
        work, secs = timings.observation(self._slot_slowdown)
        if not bool(np.any((secs > 0) & np.isfinite(secs))):
            return
        self.observe_slot_times(work, secs)

    def attach_schedule_cache(self, cache: sc.ScheduleCache) -> None:
        """Adopt an externally owned cache (multi-tenant coordination).

        The job replays and records into ``cache`` from the next batch on
        and takes its policy. The job keeps its backend's drift
        reduction: a cache without a ``drift_fn`` inherits the sharded
        backend's.
        """
        self.cfg = dataclasses.replace(self.cfg, reuse=cache.policy)
        if cache.drift_fn is None:
            cache.drift_fn = self._make_sharded_drift()
        self.schedule_cache = cache

    def load_snapshot(self, snapshot) -> sc.CachedSchedule:
        """Install a persisted plan so a warm process skips the first replan.

        ``snapshot`` is a :class:`~repro_torch.core.schedule_cache.
        CachedSchedule` or its ``to_json`` dict (either package's).
        Requires ``cfg.reuse`` — the snapshot lands in the schedule cache
        and the first batch goes through the normal drift check instead of
        the cold replan.
        """
        if self.schedule_cache is None:
            raise ValueError("load_snapshot requires MapReduceConfig(reuse=...)")
        if isinstance(snapshot, dict):
            snapshot = sc.CachedSchedule.from_json(snapshot)
        m, n = self.cfg.num_slots, self.cfg.num_clusters
        if snapshot.schedule.num_slots != m:
            raise ValueError(
                f"snapshot has {snapshot.schedule.num_slots} slots, config {m}")
        if snapshot.schedule.assignment.shape[0] != n:
            raise ValueError(
                f"snapshot covers {snapshot.schedule.assignment.shape[0]} "
                f"clusters, config {n}")
        # Warm-start the estimator with the plan-time speeds, so that a
        # snapshot built for measured speeds meets its first drift check
        # with an estimate to compare (no measurement at all reads as
        # conservative ``inf`` and would replan at once).
        if self.speed_estimator is not None and self.speed_estimator.observations == 0:
            self.speed_estimator.seed(snapshot.schedule.slot_speeds)
        self.schedule_cache.store(snapshot)
        return snapshot

    # -- the sharded backend's plumbing ---------------------------------------
    #
    # Phase tensors are lists of per-group tensors: one group of m rows on
    # the stacked backend, m groups of one row (slot j on devices[j]) on the
    # sharded backend. The sharded collectives run on the slots' streams,
    # ordered by CUDA events; a tensor that another stream reads is recorded
    # on that stream, so the allocator does not hand its memory out early.

    def _as_groups(self, x) -> list:
        """A phase value in its backend's form (the stacked backend's one
        value, the sharded backend's per-slot list) → a per-group list."""
        return [x] if self.backend == "stacked" else list(x)

    def _from_groups(self, groups: list):
        """Inverse of :meth:`_as_groups`."""
        return groups[0] if self.backend == "stacked" else groups

    def _groups(self):
        """``(rows' slot indices, device)`` of each group."""
        m = self.cfg.num_slots
        if self.backend == "stacked":
            return [(list(range(m)), self.device)]
        return [([j], d) for j, d in enumerate(self.devices)]

    def _on_slot(self, j: int):
        """Context of group ``j``'s program: its device and stream."""
        stack = contextlib.ExitStack()
        stream = self.streams[j] if self.streams is not None else None
        if stream is not None:
            stack.enter_context(torch.cuda.device(stream.device))
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _mark(self, j: int):
        """An event after everything slot ``j`` enqueued so far (None on the CPU)."""
        stream = self.streams[j] if self.streams is not None else None
        if stream is None:
            return None
        event = torch.cuda.Event()
        event.record(stream)
        return event

    def _main_stream(self):
        """The caller's stream on the first slot's device (None on the CPU)."""
        return torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

    def _fork(self) -> None:
        """Every slot stream waits for the caller's work (its inputs)."""
        main = self._main_stream()
        if main is not None and self.streams is not None:
            for stream in self.streams:
                stream.wait_stream(main)

    def _gather(self, parts):
        """Concatenate per-group tensors along dim 0 on the first device.

        The stacked backend's single group is returned as it is. On the
        sharded backend the caller's stream waits on every slot first.
        """
        if self.backend == "stacked":
            return parts[0]
        main = self._main_stream()
        pieces = []
        for j, t in enumerate(parts):
            if main is not None:
                main.wait_event(self._mark(j))
                t.record_stream(main)
            pieces.append(t.to(self.device))
        return torch.cat(pieces)

    def _scatter(self, t: torch.Tensor):
        """``t`` (on the caller's stream) copied to every slot's device and stream."""
        main = self._main_stream()
        out = []
        for j, (_, dev) in enumerate(self._groups()):
            with self._on_slot(j):
                if main is not None:
                    self.streams[j].wait_stream(main)
                    t.record_stream(self.streams[j])
                out.append(t.to(dev))
        return out

    def _copy_to(self, dst: int, sends, events, chunk: int):
        """The chunk "copy" of slot ``dst``: bucket ``[src, dst]`` of every
        sender, in sender order, after each sender's spill event. A job of
        one slot holds every sender, so its spill is a :class:`_Kept`, and
        nothing is exchanged."""
        if isinstance(sends[dst], _Kept):
            return _copy_chunk(sends[dst], chunk)
        with spans.stage("phase_b.copy"):
            return tuple(t.flatten(1, 2) for t in self._exchange_to(
                dst, [send[chunk] for send in sends], events))

    def _exchange_to(self, dst: int, parts, events):
        """What slot ``dst`` receives in an all-to-all: for each tensor of
        the senders' ``parts`` (``(1, m, ...)`` each, row ``dst`` addressed
        to it), row ``dst`` of every sender in sender order, ``(1, m,
        ...)``, after each sender's event."""
        stream = self.streams[dst] if self.streams is not None else None
        dev = self.devices[dst]
        if stream is not None:
            for src in range(len(parts)):
                if src != dst:
                    stream.wait_event(events[src])
        out = []
        for k in range(len(parts[0])):
            pieces = []
            for src, sent in enumerate(parts):
                piece = sent[k][0, dst]
                if stream is not None and src != dst:
                    piece.record_stream(stream)
                pieces.append(piece.to(dev))
            out.append(torch.stack(pieces)[None])
        return tuple(out)

    def _drive_sharded(self, bodies):
        """Run one phase-B body per slot in lockstep: each slot's program
        runs on its own stream up to its next collective, which the runner
        performs once every slot has reached it."""
        m = len(bodies)
        replies = [None] * m
        results = [None] * m
        sends, events = [None] * m, [None] * m
        while True:
            msgs = []
            for j, body in enumerate(bodies):
                with self._on_slot(j):
                    try:
                        msgs.append(body.send(replies[j]))
                    except StopIteration as stop:
                        results[j] = stop.value
                        msgs.append(None)
            if all(msg is None for msg in msgs):
                return results
            kinds = {msg[0] if msg is not None else None for msg in msgs}
            if len(kinds) != 1:
                raise RuntimeError(f"the slots' programs diverged: {sorted(map(str, kinds))}")
            kind = msgs[0][0]
            if kind == "spill":
                for j, msg in enumerate(msgs):
                    sends[j], events[j] = msg[1], self._mark(j)
                replies = [None] * m
            elif kind == "copy":
                replies = []
                for j, msg in enumerate(msgs):
                    with self._on_slot(j):
                        replies.append(self._copy_to(j, sends, events, msg[1]))
            elif kind in ("replicas", "packets"):
                parts = [msg[1] if kind == "replicas" else (msg[1],) for msg in msgs]
                marks = [self._mark(j) for j in range(m)]
                replies = []
                for j in range(m):
                    with self._on_slot(j):
                        got = self._exchange_to(j, parts, marks)
                    replies.append(got if kind == "replicas" else got[0])
            else:   # pmax
                replies = self._scatter(
                    self._gather([msg[1].reshape(1) for msg in msgs]).amax())

    def _make_sharded_drift(self):
        """A ``drift_fn`` for :class:`~repro_torch.core.schedule_cache.ScheduleCache`.

        Sharded backend only (``None`` on the stacked one): the plan-time
        statistics are uploaded ONCE, row ``j`` to slot ``j``'s device, the
        drift of each slot's row runs next to its fresh statistics, and
        only the maximum over slots (the reference's ``pmax``) reaches the
        host.
        """
        if self.backend != "sharded" or self.cfg.reuse is None:
            return None
        metric = self.cfg.reuse.metric

        def put(hist: np.ndarray):
            rows = []
            for j, (_, dev) in enumerate(self._groups()):
                with self._on_slot(j):
                    rows.append(torch.as_tensor(hist[j:j + 1], device=dev))
            return rows

        def drift(snapshot: sc.CachedSchedule, fresh_rows):
            """Scalar drift of the per-slot ``fresh_rows`` vs the resident baseline."""
            ref = snapshot.hist_device(put=put)
            per_slot = []
            for j, row in enumerate(fresh_rows):
                with self._on_slot(j):
                    per_slot.append(sc.drift_metric(ref[j], row, metric).reshape(1))
            return self._gather(per_slot).amax()

        return drift

    def _map_phase(self, inputs, prefix_fraction):
        """Phase A: ``(intermediate, state)`` in the backend's form — per
        group, the ``(key_hashes, values, valid)`` tuple and the ``(rows,
        S)`` statistics."""
        n = self.cfg.num_clusters
        if self.backend == "stacked":
            with spans.stage("phase_a.map_stats"):
                return _phase_a(inputs, self.map_fn, n, self._stats.collect, prefix_fraction)
        self._fork()
        intermediate, state = [], []
        for j, (_, dev) in enumerate(self._groups()):
            with self._on_slot(j), spans.stage("phase_a.map_stats"):
                inter, st = _phase_a(_slot_slice(inputs, j, dev), self.map_fn, n,
                                     self._stats.collect, prefix_fraction)
            intermediate.append(inter)
            state.append(st)
        return intermediate, state

    # -- measured shuffle-volume accounting ----------------------------------

    def _wire_rate(self) -> float:
        """Measured wire bytes per non-local pair (model default until measured).

        ``shuffle_bytes / shuffle_pairs`` of the last accounted batch: the
        per-pair cost the flow-shop cost model's copy phase should charge.
        Falls back to the simulator's modeled 64 B/pair.
        """
        if self._last_wire is not None and self._last_wire[1] > 0:
            return max(1e-6, self._last_wire[0] / self._last_wire[1])
        return 64.0

    @allowlist.allow_callback
    def _wire_accounting(self, wire, values, replication: int) -> dict:
        """Convert the device row counters into bytes (static row sizes).

        ``wire`` is phase B's ``[wire_rows, replica_rows, inexact,
        nonlocal_pairs]`` vector. Bytes a row are static properties of the
        wire format: uncoded rows carry the payload (quantized or native)
        plus a 4-byte cluster id; coded packet rows are XOR word slabs
        (payload words + cluster word + position word); replica rows ship
        the raw record (payload + 4-byte key hash).
        """
        with spans.host("phase_b.pull"):
            # analysis: allow-callback
            rows, rep_rows, inexact, pairs = (int(x) for x in wire.tolist())
        quantize = self.cfg.quantize_shuffle
        v_dim = int(values.shape[-1])
        if replication > 1:
            pay = _wire_payload_dtype(quantize, values.dtype)
            row_bytes = (cs_ops.packed_width(v_dim, pay) + 2) * 4
        else:
            row_bytes = v_dim * (1 if quantize else values.element_size()) + 4
        return {
            "shuffle_bytes": rows * row_bytes,
            "shuffle_rows": rows,
            "shuffle_pairs": pairs,
            "replication_bytes": rep_rows * (v_dim * values.element_size() + 4),
            "inexact": inexact,
        }

    # -- planning (the host "JobTracker" step) -------------------------------

    def _plan(
        self,
        local_hist: np.ndarray,
        key_dist: Optional[np.ndarray],
        k_per_shard: int,
        prev: Optional[sc.CachedSchedule] = None,
        num_chunks: Optional[int] = None,
        assignment_override: Optional[np.ndarray] = None,
        strategy_override: Optional[str] = None,
        pinned_first: Optional[np.ndarray] = None,
        chunk0_cap: Optional[int] = None,
    ) -> sc.CachedSchedule:
        """One host planning step: schedule + §4.4 waves + send capacities.

        Pure host computation from the per-shard statistics, the
        reference's planner line for line; the returned
        :class:`~repro_torch.core.schedule_cache.CachedSchedule` fully
        determines phase B, so it can be replayed across batches. ``prev``
        is the outgoing snapshot when replanning under a reuse policy —
        capacities take the elementwise max with it, so repeated replans
        of one workload converge on one set of buffer shapes.

        ``local_hist`` is *provider state*: the exact ``(m, n)``
        histogram, or ``(m, depth * width)`` count-min cells under
        ``cfg.stats == "sketch"`` — in which case every planning input is
        O(sketch size), capacities come from overestimate-only cell bounds,
        and the passed ``key_dist`` is ignored (callers may pass ``None``).

        ``num_chunks`` overrides ``cfg.pipeline_chunks`` — the elastic
        recovery path plans only the *remaining* waves after a mid-batch
        failure, so the replayed pipeline is exactly as deep as the work
        left to do.

        The remaining keywords serve streaming-prefix refinement
        (:meth:`_plan_prefixed`): ``assignment_override`` /
        ``strategy_override`` replay a committed cluster → slot
        assignment instead of invoking the scheduler, ``pinned_first``
        pins the committed wave-1 members to chunk 0, and ``chunk0_cap``
        clamps chunk 0 to the committed capacity — marking the plan
        ``caps_estimated`` when that cap is below the full statistics'
        bound (the runner's overflow escape hatch restores exactness).
        """
        cfg = self.cfg
        m, n = cfg.num_slots, cfg.num_clusters
        pipeline_chunks = num_chunks if num_chunks is not None else cfg.pipeline_chunks
        speeds = self.current_speeds()
        provider = self._stats
        state = np.asarray(local_hist)
        # f32 integer-exactness guard on the RAW device counters — the
        # histogram cells, or the count-min cells whose estimates are only
        # trustworthy while every cell is still exact. A saturated counter
        # voids the statistics-sized bounds, so all of them fall back to
        # the safe k_per_shard.
        raw_max = float(state.max()) if state.size else 0.0
        hist_exact = raw_max < sp.F32_EXACT_MAX
        if provider.kind == "sketch":
            # No (m, n) densify here: capacities come straight from the
            # cells (provider.send_bound) and only the (n,) global
            # estimate is materialized for the scheduler.
            dense_hist = None
            key_dist = provider.key_dist(state)
        else:
            dense_hist = state
            key_dist = (np.asarray(key_dist) if key_dist is not None
                        else provider.key_dist(state))

        # The JobTracker invokes the scheduling algorithm (§4.1 step 4),
        # assigning by earliest finish time under the per-slot speeds
        # (Q||C_max; None ≡ identical slots). "auto" tries every candidate
        # and keeps the one with the lowest estimated Reduce makespan.
        strategy_costs = None
        if assignment_override is not None:
            # Prefix refinement: the assignment was committed by the
            # wave-1 plan; only waves and capacities are recomputed.
            strategy = strategy_override or cfg.scheduler
            schedule = sched_lib.Schedule.from_assignment(
                np.asarray(assignment_override, np.int32), key_dist, m,
                speeds=speeds)
        elif cfg.scheduler == "auto":
            strategy, schedule, strategy_costs = sim.pick_strategy(
                key_dist, m, eta=cfg.eta,
                pipelined=cfg.pipelined and pipeline_chunks > 1,
                speeds=speeds,
                # Measured wire rate (last batch) + per-slot locality.
                bytes_per_pair=self._wire_rate(),
                # The locality-aware wire model wants per-shard (m, n)
                # counts; a sketch densifies its estimates only here.
                local_hist=(provider.to_dense(state) if dense_hist is None
                            else dense_hist),
            )
        else:
            strategy = cfg.scheduler
            scheduler = sched_lib.get_scheduler(cfg.scheduler)
            if cfg.scheduler == "hash":
                schedule = scheduler(key_dist, m, keys=np.arange(n), speeds=speeds)
            elif dense_hist is None:
                # Sketch plans schedule at *bin* granularity: the row-0
                # cell sums are the exact total mass landing in each bin,
                # so Q||C_max runs over ``width`` loads instead of ``n``.
                # The per-cluster assignment is a gather through the
                # row-0 hash — clusters sharing a bin travel together.
                cells = state.reshape(m, provider.depth, provider.width)
                bin_loads = np.asarray(cells[:, 0, :].sum(axis=0), np.float64)
                if cfg.scheduler in ("bss", "os4m"):
                    bin_sched = scheduler(bin_loads, m, eta=cfg.eta, speeds=speeds)
                else:
                    bin_sched = scheduler(bin_loads, m, speeds=speeds)
                assignment = bin_sched.assignment[provider.bins()[0]]
                schedule = sched_lib.Schedule.from_assignment(
                    np.asarray(assignment, np.int32), key_dist, m, speeds=speeds)
            elif cfg.scheduler in ("bss", "os4m"):
                schedule = scheduler(key_dist, m, eta=cfg.eta, speeds=speeds)
            else:
                schedule = scheduler(key_dist, m, speeds=speeds)

        # Static capacity for the all-to-all: the per-(shard,dest) worst
        # case from the per-shard statistics — shard i sends dest d exactly
        # the pairs of d's clusters that i holds. Bounds are quantized
        # (≤12.5% slack) to a bounded alphabet of buffer shapes. Under a
        # reuse policy the bound gains ``capacity_slack`` headroom first,
        # so sub-threshold drift rarely overflows a replayed plan.
        capacity = cfg.capacity_send or k_per_shard
        slack = 1.0 + (cfg.reuse.capacity_slack if cfg.reuse is not None else 0.0)

        def _quantize_cap(c: int) -> int:
            """Round up to ~1/8-octave steps: bounded cache-key alphabet."""
            c = max(1, int(c))
            if c <= 8:
                return c
            g = 1 << max(0, (c - 1).bit_length() - 3)
            return -(-c // g) * g

        def _send_bound(members) -> int:
            """max over (shard, dest) of pairs shard sends dest (+ slack)."""
            if not hist_exact:
                return k_per_shard      # saturated f32 counts: safe bound
            if len(members) == 0:
                return 1
            dests = schedule.assignment[members]
            if dense_hist is None:
                # Count-min distinct-bin bound: O(sketch), still >= the
                # true per-(shard, dest) worst case (overestimate-only).
                worst = provider.send_bound(state, dests, members, m)
            else:
                worst = 0.0
                for i in range(m):
                    per_dest = np.bincount(
                        dests, weights=dense_hist[i, members], minlength=m)
                    worst = max(worst, float(per_dest.max()))
            return min(k_per_shard, _quantize_cap(int(np.ceil(worst * slack))))

        all_members = np.arange(n)
        capacity = max(1, int(min(capacity, k_per_shard, _send_bound(all_members))))

        # Pipeline plan (§4.4): per-slot increasing-load waves merged into
        # job-wide chunks, globally ordered by finish time under the slot
        # speeds — see ``pipeline.plan_waves``.
        waves = pipe.plan_waves(key_dist, schedule.assignment, m,
                                pipeline_chunks, speeds=speeds,
                                replication=cfg.shuffle_replication,
                                pinned_first=pinned_first)
        chunk_caps = [
            int(min(capacity, _send_bound(waves.chunk_members(ci))))
            for ci in range(waves.num_chunks)
        ]
        caps_estimated = False
        if chunk0_cap is not None:
            # Streaming commitment: wave 1's buffer was sized from the
            # prefix extrapolation before the tail landed, so the refined
            # plan must replay it — even if the full statistics now say
            # it is too small (that is what the overflow hatch is for).
            chunk_caps[0] = max(1, int(min(capacity, chunk0_cap)))
            caps_estimated = chunk_caps[0] < _send_bound(waves.chunk_members(0))

        # Shape hysteresis: buffer shapes may only grow across replans of
        # one workload (bounded by k_per_shard).
        if prev is not None and prev.waves.num_chunks == waves.num_chunks:
            capacity = max(capacity, prev.capacity)
            chunk_caps = [max(a, b) for a, b in zip(chunk_caps, prev.chunk_caps)]

        return sc.CachedSchedule(
            schedule=schedule,
            strategy=strategy,
            strategy_costs=strategy_costs,
            waves=waves,
            capacity=capacity,
            chunk_caps=tuple(int(c) for c in chunk_caps),
            local_hist=state,
            key_dist=np.asarray(key_dist),
            k_per_shard=int(k_per_shard),
            stats_provider=provider.kind,
            stats_params=provider.params(),
            stats_overestimate=not caps_estimated,
            caps_estimated=caps_estimated,
        )

    def _plan_prefixed(self, state: np.ndarray, prefix_state: np.ndarray,
                       k_per_shard: int,
                       prev: Optional[sc.CachedSchedule] = None) -> sc.CachedSchedule:
        """Streaming-prefix planning: commit wave 1 early, refine the rest.

        1. Plan from the *prefix* sketch scaled by ``1 / stream_prefix``
           (the prefix extrapolated to the full batch). This commits the
           cluster → slot assignment, wave 1's membership, and wave 1's
           send capacity — everything a streaming deployment would have
           dispatched before the tail landed.
        2. Re-plan from the full-batch sketch, replaying the committed
           assignment, pinning the committed wave-1 members to chunk 0 and
           clamping chunk 0 to the committed capacity — only the tail
           waves are re-cut and re-sized.

        The refined plan is what phase B executes; when the committed
        wave-1 cap under-provisions, the overflow hatch
        (:meth:`_escalate_caps`) restores exactness.
        """
        frac = self.cfg.stream_prefix
        plan1 = self._plan(prefix_state / frac, None, k_per_shard)
        return self._plan(
            state, None, k_per_shard, prev=prev,
            assignment_override=plan1.schedule.assignment,
            strategy_override=plan1.strategy,
            pinned_first=plan1.waves.chunk_members(0),
            chunk0_cap=plan1.chunk_caps[0],
        )

    def _escalate_caps(self, planned: sc.CachedSchedule) -> sc.CachedSchedule:
        """Exactness escape hatch for estimate-committed capacities.

        Capacities only gate buffer sizing — assignment, wave membership
        and reduce order are untouched — so the recovery is not a replan:
        the same plan is re-issued with every capacity raised to the safe
        bound ``min(capacity_send, k_per_shard)``, which no slot can
        overflow. The re-execution sizes its buffers by
        :meth:`_needed_caps`, not by that bound.
        """
        safe = self._safe_cap(planned)
        return dataclasses.replace(
            planned,
            capacity=safe,
            chunk_caps=tuple(safe for _ in range(planned.waves.num_chunks)),
            stats_overestimate=True,
            caps_estimated=False,
        )

    def _safe_cap(self, planned: sc.CachedSchedule) -> int:
        """The capacity no slot can overflow: ``min(capacity_send, k_per_shard)``."""
        k = int(planned.k_per_shard)
        return max(1, int(min(self.cfg.capacity_send or k, k)))

    def _escalated(self, planned: sc.CachedSchedule) -> bool:
        """True for a plan of :meth:`_escalate_caps`: every cap at the safe bound."""
        safe = self._safe_cap(planned)
        return (planned.stats_overestimate and planned.capacity == safe
                and all(c == safe for c in planned.chunk_caps))

    @allowlist.allow_callback
    def _needed_caps(self, intermediate, planned: sc.CachedSchedule):
        """Buffer sizes that run ``planned`` with the same drops, and no more.

        Each planned capacity is cut to the most pairs that any (sender,
        destination) group under it holds in this batch. A group's pairs
        past its capacity are the ones dropped, so the cut caps drop the
        same pairs, keep every pair's place in its cluster's stream, and
        give the same outputs and overflow bit for bit. The escalated
        plan's safe bound, ``k_per_shard`` for every chunk, would size the
        spill at ``m² · k_per_shard · chunks`` rows; the cut caps size it
        by what the batch holds. One ``(chunks + 1,)`` pull a group;
        returns ``(capacity, chunk_caps)``.
        """
        m, n = self.cfg.num_slots, self.cfg.num_clusters
        chunks = planned.waves.num_chunks
        groups = chunks * m
        need = np.zeros(chunks + 1, np.int64)
        for j, ((key_hashes, _, valid), (_, dev)) in enumerate(zip(
                self._as_groups(intermediate), self._groups())):
            with self._on_slot(j):
                rows = key_hashes.shape[0]
                cid = _cluster_ids(key_hashes, n).long()
                assign = torch.as_tensor(planned.schedule.assignment, dtype=torch.long,
                                         device=dev)
                chunk_of = torch.as_tensor(planned.waves.chunk_of_cluster,
                                           dtype=torch.long, device=dev)
                group = torch.where(valid, chunk_of[cid] * m + assign[cid], groups)
                flat = group + torch.arange(rows, device=dev)[:, None] * (groups + 1)
                per_group = torch.bincount(flat.reshape(-1), minlength=rows * (groups + 1))
                per_group = per_group.view(rows, groups + 1)[:, :groups].reshape(
                    rows, chunks, m)
                # analysis: allow-callback
                need = np.maximum(need, torch.cat([
                    per_group.amax(dim=(0, 2)),
                    per_group.sum(dim=1).amax().reshape(1)]).cpu().numpy())
        chunk_caps = tuple(max(1, min(int(c), int(k)))
                           for c, k in zip(planned.chunk_caps, need[:-1]))
        return max(1, min(int(planned.capacity), int(need[-1]))), chunk_caps

    # -- execution (phase B under one plan) ----------------------------------

    def _static(self, planned: sc.CachedSchedule, caps=None) -> tuple:
        """Phase B's static configuration under ``planned`` (and ``caps``)."""
        cfg = self.cfg
        capacity, chunk_caps = caps or (planned.capacity, planned.chunk_caps)
        return (cfg.num_slots, cfg.num_clusters, capacity, tuple(chunk_caps),
                cfg.reduce_op, cfg.pipelined, planned.waves.num_chunks,
                cfg.quantize_shuffle)

    def _plan_tensors(self, planned: sc.CachedSchedule, dev):
        """The plan's assignment, pipeline ranks and chunk map on ``dev``."""
        with spans.host("phase_b.upload"):
            return tuple(torch.as_tensor(a, dtype=torch.int32, device=dev) for a in (
                planned.schedule.assignment, planned.waves.rank_of_cluster,
                planned.waves.chunk_of_cluster))

    def _execute(self, intermediate, planned: sc.CachedSchedule, caps=None,
                 stamp_through=None):
        """Run phase B under one plan (fresh or replayed); device results.

        ``caps`` (``(capacity, chunk_caps)``) overrides the plan's buffer
        sizes (see :meth:`_needed_caps`). The wire format rides the plan,
        not the config: a replayed or loaded snapshot runs coded exactly
        when it was planned coded. ``stamp_through`` is the measured
        executor's tick hook (see :func:`_phase_b_body`). Takes and returns
        the backend's form: ``(out (rows, n, V), counts (rows, n),
        overflow, wire[, ticks])`` of the stacked rows, or a list of them,
        one a slot.
        """
        static = self._static(planned, caps)
        coded = planned.waves.replication > 1
        if coded and stamp_through is not None:
            raise ValueError(
                "a coded plan cannot run with measured timings — the coded"
                " decode is not stamp-instrumented; set measure_timings=False")
        self._count_bucket_rows(intermediate, static, coded)
        bodies = []
        for j, (inter, (slots, dev)) in enumerate(zip(self._as_groups(intermediate),
                                                      self._groups())):
            with self._on_slot(j):
                plan = self._plan_tensors(planned, dev)
                if coded:
                    bodies.append(_phase_b_coded(inter, *plan, static, slots))
                else:
                    me = torch.as_tensor(slots, device=dev)
                    bodies.append(_phase_b_body(inter, *plan, static, me, stamp_through))
        if self.backend == "stacked":
            return _drive_stacked(bodies[0])
        return self._drive_sharded(bodies)

    def _execute_measured(self, intermediate, planned: sc.CachedSchedule, caps=None):
        """Overlapped phase B with per-slot wave stamps (no fencing).

        Runs the SAME double-buffered walk as :meth:`_execute` — one
        phase-B body, with the ``wave_timer`` stamp hook — so outputs are
        bit-identical to it. Each slot's ``(waves, 2, 2)`` stamp words are
        read after the batch into :class:`~repro_torch.core.mesh_timing.
        WaveTimings`. Without a tick source (``wave_timer.ops.available()``
        False; on a card only under ``force_backend("none")``) it falls
        back to :meth:`_execute_measured_fenced`.

        Returns ``(results, timings)``, the results as :meth:`_execute`
        returns them without the tick words.
        """
        if not wt_ops.available(self.device):
            return self._execute_measured_fenced(intermediate, planned, caps)
        results = self._as_groups(self._execute(intermediate, planned, caps,
                                                stamp_through=wt_ops.stamp_through))
        words = []
        for j, res in enumerate(results):
            with self._on_slot(j):
                words.append(wt_ops.ticks_numpy(res[4]))
        timings = mt.WaveTimings.from_ticks(
            wt_ops.combine_ticks(np.stack(words)),
            wt_ops.tick_calibration(self.device).seconds_per_tick)
        return self._from_groups([res[:4] for res in results]), timings

    @allowlist.allow_callback
    def _execute_measured_fenced(self, intermediate, planned: sc.CachedSchedule, caps=None):
        """Fenced fallback: per-wave steps + host-attributed clocks.

        For runs without a tick source. Same math as :meth:`_execute`,
        other structure: a per-slot spill, then for each wave one "copy"
        step (the gather between slots — not attributed, since it waits on
        every sender) and one "run" step per slot (its reduce alone),
        whose completion is polled per slot by
        :func:`~repro_torch.core.mesh_timing.shard_ready_seconds`. The
        waves are walked in the same order with the same per-chunk reduce
        and merge, so outputs are bit-identical to the overlapped path;
        the price is the lost copy/run overlap. A wave whose run step
        built or loaded a kernel library is not a measurement
        (``valid=False``).

        Measured timings exist on the sharded backend only. Returns
        ``(results, timings)`` like :meth:`_execute_measured`.
        """
        cfg = self.cfg
        if planned.waves.replication > 1 or cfg.quantize_shuffle:
            raise ValueError(
                "the fenced measured fallback has its own copy programs and"
                " does not implement the coded/quantized wire — disable"
                " measure_timings (or provide a tick source) to run"
                " shuffle_replication>1 / quantize_shuffle jobs")
        static = self._static(planned, caps)
        (m, n, _, _, reduce_op, pipelined, num_chunks, _) = static
        pipelined = pipelined and num_chunks > 1
        waves = num_chunks if pipelined else 1
        groups = self._groups()
        plans, sends, events, overflow, rows = self._spill_groups(intermediate, planned, static)
        wire = [torch.stack([r, torch.zeros_like(r), torch.zeros_like(r), r]) for r in rows]
        timings = mt.WaveTimings.empty(m, waves)
        acc = cnt = None
        for c in range(waves):
            recv = []
            for j in range(m):
                with self._on_slot(j):
                    recv.append(self._wave_copy(j, sends, events, c))
            if self.device.type == "cuda":               # the fence
                for dev in {d for _, d in groups}:
                    torch.cuda.synchronize(dev)      # analysis: allow-callback
            loads0 = _build.loads
            markers = []
            outs = []
            t0 = time.perf_counter()
            for j, got in enumerate(recv):
                with self._on_slot(j), spans.stage("phase_b.reduce"):
                    outs.append(_reduce_received(sends[j], got, plans[j], n, reduce_op))
                markers.append(self._mark(j) if self.device.type == "cuda"
                               else time.perf_counter())
            timings.record(c, mt.shard_ready_seconds(markers, t0))
            if _build.loads != loads0:
                timings.valid = False
            if not pipelined:
                acc, cnt = [o[0] for o in outs], [o[1] for o in outs]
                continue
            if acc is None:
                values = [inter[1] for inter in intermediate]
                acc = [torch.zeros((v.shape[0], n, v.shape[-1]),
                                   dtype=torch.float32 if reduce_op == "sum" else v.dtype,
                                   device=v.device) for v in values]
                cnt = [torch.zeros(o[1].shape, dtype=torch.float32, device=o[1].device)
                       for o in outs]
            for j, (out_c, cnt_c) in enumerate(outs):
                with self._on_slot(j):
                    acc[j], cnt[j] = _merge_chunk(acc[j], cnt[j], out_c, cnt_c, reduce_op)
        return list(zip(acc, cnt, overflow, wire)), timings

    def _count_bucket_rows(self, intermediate, static, coded: bool = False) -> None:
        """Add one execution's laid-out rows (:func:`_bucket_rows`) to the
        run's ``bucket_rows``; a coded plan's leaves it ``None``."""
        if self._run_bucket_rows is None:
            return
        if coded:
            self._run_bucket_rows = None
            return
        self._run_bucket_rows += sum(_bucket_rows(static, *inter[0].shape)
                                     for inter in self._as_groups(intermediate))

    def _spill_groups(self, intermediate, planned: sc.CachedSchedule, static):
        """Every group's spill for a fenced walk. Per group: the plan's
        tensors on its device, the chunks' spilled pairs, an event after
        the spill, and :func:`_spill`'s overflow and wire-row scalars;
        returns the five lists."""
        self._count_bucket_rows(intermediate, static)
        plans, sends, events, overflow, rows = [], [], [], [], []
        for j, (inter, (slots, dev)) in enumerate(zip(self._as_groups(intermediate),
                                                      self._groups())):
            with self._on_slot(j):
                plans.append(self._plan_tensors(planned, dev))
                me = torch.as_tensor(slots, device=dev)
                with spans.stage("phase_b.spill"):
                    send, ovf, wire_rows = _spill(inter, *plans[j], static, me, inter[1],
                                                  inter[1])
                sends.append(send)
                overflow.append(ovf)
                rows.append(wire_rows)
            events.append(self._mark(j))
        return plans, sends, events, overflow, rows

    def _mask_completed(self, intermediate, completed: np.ndarray):
        """Invalidate every pair whose cluster already checkpointed.

        ``valid & ~completed[|key_hash| % n]``: one elementwise op per slot
        group, no collectives. The replayed phase B then reduces exactly
        the pairs of the unfinished waves — completed clusters contribute
        nothing twice. Takes and returns the backend's form.
        """
        n = self.cfg.num_clusters
        out = []
        for j, ((key_hashes, values, valid), (_, dev)) in enumerate(zip(
                self._as_groups(intermediate), self._groups())):
            with self._on_slot(j):
                done = torch.as_tensor(completed, dtype=torch.bool, device=dev)
                out.append((key_hashes, values,
                            valid & ~done[_cluster_ids(key_hashes, n).long()]))
        return self._from_groups(out)

    def _wave_copy(self, j: int, sends, events, chunk: int):
        """Group ``j``'s received chunk ``chunk``: the stacked backend's
        segment row (:func:`_copy_chunk`), or the sharded copy of slot
        ``j`` (:meth:`_copy_to`)."""
        if self.backend == "stacked":
            return _copy_chunk(sends[0], chunk)
        return self._copy_to(j, sends, events, chunk)

    @allowlist.allow_callback
    def _host_merge(self, outs):
        """One wave's per-group ``(out, counts)`` → host ``(values (n, V),
        counts (n,))``, summed over slots (each cluster is reduced on one
        slot), as :meth:`run` merges a whole batch."""
        m, n = self.cfg.num_slots, self.cfg.num_clusters
        with spans.host("phase_b.pull"):
            # analysis: allow-callback
            values = self._gather([o[0] for o in outs]).cpu().numpy().reshape(m, n, -1).sum(
                axis=0)
            # analysis: allow-callback
            counts = self._gather([o[1] for o in outs]).cpu().numpy().reshape(m, n).sum(axis=0)
        return values, counts

    def _execute_checkpointed(self, intermediate, planned: sc.CachedSchedule, local_k,
                              k_per_shard: int, caps=None):
        """Phase B with host checkpoints at wave granularity (elastic mesh).

        Walks the §4.4 waves one fenced copy → run pair at a time, with
        the steps of the other executors: one :func:`_spill` per slot
        group, then per wave the chunk "copy", :func:`_reduce_chunk`
        (kernel 2 for ``sum``) and a merge, which pulls the wave's outputs
        to the host (the fence). Every cluster lives in exactly one wave
        and is reduced on exactly one slot, and merging its single
        non-zero contribution with exact zeros is order-insensitive, so
        an uninterrupted walk is **bit-identical** to the fused pipeline.
        After each wave the merged outputs land in a host
        :class:`~repro_torch.core.pipeline.WaveCheckpoint`.

        An armed kill (``set_slot_failure(slot, at_wave=w)``) fires just
        before wave ``w``: the slot is marked dead, the walk's spill is
        released, the *remaining* load (fresh ``K^(i)`` with completed
        clusters zeroed) is re-planned onto the surviving slots with
        exactly ``num_chunks − w`` chunks, completed clusters are masked
        out of the intermediate pairs, and :meth:`_execute` replays only
        that residue — so recovery costs the remaining waves' work, never
        the whole batch. A kill armed past the last wave fires between
        batches: the slot is dead for the next plan.

        ``caps`` (``(capacity, chunk_caps)``) sizes the walk's buffers as
        in :meth:`_execute`; with ``caps`` given the residue replays at
        its own plan's cut caps too (:meth:`_needed_caps`).

        Returns host ``(values (n, V), counts (n,), overflow_total)``.
        """
        cfg = self.cfg
        n = cfg.num_clusters
        static = self._static(planned, caps)
        (_, _, _, _, reduce_op, pipelined, num_chunks, _) = static
        pipelined = pipelined and num_chunks > 1
        waves_total = num_chunks if pipelined else 1
        ckpt = pipe.WaveCheckpoint(num_chunks=waves_total)
        state = {"values": None, "counts": None, "overflow": 0, "replayed": 0}

        def absorb(o, ct):
            """Merge one wave into the host accumulators (replace for max)."""
            if state["values"] is None:
                state["values"], state["counts"] = np.zeros_like(o), np.zeros_like(ct)
            if reduce_op == "max":
                state["values"] = np.where(ct[:, None] > 0, o, state["values"])
            else:
                state["values"] = state["values"] + o
            state["counts"] = state["counts"] + ct

        @allowlist.allow_callback
        def overflow_of(counts):
            """Sum of the groups' overflow scalars, pulled."""
            with spans.host("phase_b.pull"):
                # analysis: allow-callback
                return int(self._gather([c.reshape(1) for c in counts]).sum())

        def fire(due):
            """Mark the due slots dead (pops their armed kills)."""
            for slot in due:
                self._kill_at_wave.pop(slot, None)
                self._mark_slot_dead(slot)

        @allowlist.allow_callback
        def replay(cursor: int):
            """Re-plan + re-execute the unfinished waves on the survivors."""
            completed = (ckpt.completed_clusters if ckpt.completed_clusters is not None
                         else np.zeros(n, dtype=bool))
            # analysis: allow-callback
            hist = self._gather(local_k).cpu().numpy().astype(np.float64)
            hist[:, completed] = 0.0
            replan = self._plan(hist, hist.sum(axis=0), k_per_shard, prev=None,
                                num_chunks=max(1, waves_total - cursor))
            masked = self._mask_completed(intermediate, completed)
            replay_caps = self._needed_caps(masked, replan) if caps is not None else None
            results = self._as_groups(self._execute(masked, replan, replay_caps))
            absorb(*self._host_merge(results))
            state["overflow"] += overflow_of([r[2] for r in results])
            state["replayed"] = (replan.waves.num_chunks
                                 if cfg.pipelined and replan.waves.num_chunks > 1 else 1)
            self.last_replay_plan = replan

        def due(c: int):
            return [slot for slot, w in self._kill_at_wave.items() if w <= c]

        if not pipelined:
            if due(0):
                fire(due(0))
                replay(0)
            else:
                results = self._as_groups(self._execute(intermediate, planned, caps))
                absorb(*self._host_merge(results))
                state["overflow"] += overflow_of([r[2] for r in results])
                ckpt.mark_wave(np.arange(n), {}, n)
        else:
            plans, sends, events, overflow, _ = self._spill_groups(intermediate, planned, static)
            state["overflow"] += overflow_of(overflow)
            for c in range(num_chunks):
                if due(c):
                    fire(due(c))
                    del sends, events       # the walk's spill, before the residue's
                    replay(c)
                    break
                outs = []
                for j in range(len(plans)):
                    with self._on_slot(j):
                        recv = self._wave_copy(j, sends, events, c)
                        with spans.stage("phase_b.reduce"):
                            outs.append(_reduce_received(sends[j], recv, plans[j], n,
                                                         reduce_op))
                        del recv
                o, ct = self._host_merge(outs)
                del outs
                absorb(o, ct)
                members = planned.waves.chunk_members(c)
                ckpt.mark_wave(members, {int(k): o[k] for k in members}, n)

        if self._kill_at_wave:
            fire(list(self._kill_at_wave))
        self.last_checkpoint = ckpt
        self.last_checkpoint_wave = ckpt.wave_cursor
        self.last_replayed_waves = state["replayed"]
        return state["values"], state["counts"], state["overflow"]

    # -- public API ----------------------------------------------------------

    def run(self, inputs) -> JobResult:
        """Execute the full job: phase A → {replay cached | host plan} → phase B.

        Without a reuse policy this is the paper's per-job workflow (host
        schedule every run). With ``cfg.reuse`` set, the per-shard
        statistics feed a drift check on the device first; a reused batch
        pulls only the ``(S,)`` slot-sum of the statistics, skips the
        scheduler and replays the cached plan. With ``estimate_speeds``
        the batch's wave timings (measured on the sharded backend,
        synthetic on the stacked one) update the speeds the next plan
        uses. ``last_phase_ms`` and ``last_spans`` then time the run (see
        :mod:`repro_torch.core.spans`).
        """
        on = spans.enabled(self.trace)
        with self._spans.run(on, self._span_stream() if on else None):
            return self._run(inputs)

    def _span_stream(self):
        """Where a run's device stages record their events (``Spans.run``)."""
        if self.device.type != "cuda":
            return None
        return spans.CURRENT if self.backend == "sharded" else self._main_stream()

    @allowlist.allow_callback
    def _run(self, inputs) -> JobResult:
        cfg = self.cfg
        m, n = cfg.num_slots, cfg.num_clusters
        self._spans.phase("phase_a")
        self._run_bucket_rows = 0

        # ---- Phase A: map + statistics (all Maps finish before any Reduce).
        intermediate, state = self._map_phase(inputs, cfg.stream_prefix)
        for inter, (slots, dev) in zip(self._as_groups(intermediate), self._groups()):
            for t in inter:
                if t.device != dev:
                    raise ValueError(
                        f"map_fn returned a tensor on {t.device}; this job runs"
                        f" {'its slots' if len(slots) > 1 else f'slot {slots[0]}'} on {dev}")
            if inter[0].shape[0] != len(slots):
                raise ValueError(
                    f"map_fn returned {inter[0].shape[0]} slots, expected {len(slots)}")
        # Provider state, still on the device(s): per group (rows, S), S = n
        # exact or depth * width sketch; streaming-prefix mode doubles it
        # (columns [0:S) full batch, [S:2S) the prefix — see _phase_a).
        provider = self._stats
        local_k = [st.reshape(st.shape[0], -1) for st in self._as_groups(state)]
        prefix_k = None
        if cfg.stream_prefix is not None:
            s = provider.state_size
            prefix_k = [st[:, s:] for st in local_k]
            local_k = [st[:, :s] for st in local_k]
        k_per_shard = int(self._as_groups(intermediate)[0][0].shape[-1])
        cache = self.schedule_cache

        # ---- Reuse decision (drift on the device; only a scalar reaches the
        # host), then the pull of what the host needs: the full (m, S)
        # statistics to plan, or only their (S,) slot-sum to replay. The
        # planner reads the statistics as pulled — no dtype cast, so ties
        # break as in the reference.
        decision = None
        if cache is not None:
            fresh = local_k if self.backend == "sharded" else local_k[0]
            with spans.host("phase_a.decide"):
                decision = cache.decide(fresh, fresh_speeds=self.current_speeds())
        local_hist = slot_sum = None
        with spans.host("phase_a.pull"):
            if decision is None or decision.action == "replan":
                # analysis: allow-callback
                local_hist = self._gather(local_k).cpu().numpy()
            else:
                # analysis: allow-callback
                slot_sum = self._gather(local_k).sum(dim=0).cpu().numpy()
        self._spans.phase("plan")

        benefit = None
        if (decision is not None and decision.action == "replan"
                and decision.reason == "drift" and cache.policy.cost_gate
                and cfg.scheduler == "auto"):
            # The distribution drifted — but is a fresh plan actually
            # better than the stale schedule's expected imbalance, net of
            # the scheduler's own cost? (simulator cost model)
            benefit = sim.estimate_replan_benefit(
                provider.key_dist(local_hist), cache.snapshot.schedule,
                eta=cfg.eta,
                pipelined=cfg.pipelined and cfg.pipeline_chunks > 1,
                speeds=self.current_speeds(),
                bytes_per_pair=self._wire_rate(),
                local_hist=provider.to_dense(local_hist),
            )
            if benefit["benefit"] <= 0.0:
                # Not worth it: keep the plan, re-anchor the drift
                # baseline so the question isn't re-asked every batch.
                cache.snapshot.refresh_baseline(
                    local_hist, key_dist=provider.key_dist(local_hist))
                decision = sc.ReuseDecision("reuse", "cost_gate", decision.drift,
                                            speed_drift=decision.speed_drift)

        # ---- Host plan (cold / drift / max_age / no policy) or replay.
        if decision is not None and decision.action == "reuse":
            planned = cache.snapshot
            key_dist = provider.key_dist(local_hist if local_hist is not None
                                         else slot_sum)
        else:
            key_dist = provider.key_dist(local_hist)
            prev = cache.snapshot if cache is not None else None
            if prefix_k is not None:
                # analysis: allow-callback
                prefix_hist = self._gather(prefix_k).cpu().numpy()
                planned = self._plan_prefixed(local_hist, prefix_hist, k_per_shard, prev=prev)
            else:
                planned = self._plan(local_hist, key_dist, k_per_shard, prev=prev)
            if cache is not None:
                cache.store(planned)
        self._spans.phase("phase_b")

        # ---- Phase B: measured (sharded + estimation: per-slot wave stamps,
        # host-fenced clocks only without a tick source), untimed, or (the
        # elastic mesh) the checkpointed walk, which merges on the host.
        measured = self._measure_timings and self.speed_estimator is not None
        checkpointing = cfg.checkpoint_waves and not measured
        if checkpointing:
            self.last_replay_plan = None

        @allowlist.allow_callback
        def execute(plan, caps=None):
            """Phase B under ``plan``: ``(results, overflow, timings)``. The
            checkpointed walk's results are the host ``(values, counts)``,
            the others' the per-group device results."""
            if checkpointing:
                values, counts, overflow = self._execute_checkpointed(
                    intermediate, plan, local_k, k_per_shard, caps)
                return (values, counts), overflow, None
            if measured:
                results, timings = self._execute_measured(intermediate, plan, caps)
            else:
                results, timings = self._execute(intermediate, plan, caps), None
            results = self._as_groups(results)
            with spans.host("phase_b.pull"):
                # analysis: allow-callback
                overflow = int(self._gather([r[2].reshape(1) for r in results]).sum())
            return results, overflow, timings

        # A reused escalated plan replays at the batch's cut caps, as the
        # escape hatch's re-execution below does.
        replay_escalated = (decision is not None and decision.action == "reuse"
                            and self._escalated(planned))
        results, overflow_total, timings = execute(
            planned, self._needed_caps(intermediate, planned) if replay_escalated else None)

        # ---- Capacity fallback: a replayed plan's statistics-sized
        # buffers were too small for this batch. Overflow counting is
        # exact, so replan from the fresh statistics and re-execute —
        # outputs are always the no-drop ones. A checkpointed batch's kills
        # already fired during the first walk, so its re-execution is a
        # clean checkpointed pass.
        if decision is not None and decision.action == "reuse" and overflow_total > 0:
            cache.capacity_fallbacks += 1
            # analysis: allow-callback
            local_hist = self._gather(local_k).cpu().numpy()
            key_dist = provider.key_dist(local_hist)
            planned = self._plan(local_hist, key_dist, k_per_shard,
                                 prev=cache.snapshot)
            cache.store(planned)
            decision = sc.ReuseDecision("replan", "overflow", decision.drift,
                                        speed_drift=decision.speed_drift)
            del results
            results, overflow_total, timings = execute(planned)

        # ---- Estimate-commitment fallback (streaming prefix): wave 1's
        # committed cap under-provisioned this batch. Not a replan — every
        # cap escalates to the safe bound and the batch re-executes
        # drop-free (see _escalate_caps) in buffers sized by the batch.
        if planned.caps_estimated and overflow_total > 0:
            self.capacity_fallbacks += 1
            planned = self._escalate_caps(planned)
            if cache is not None:
                cache.store(planned)
            del results
            results, overflow_total, timings = execute(
                planned, self._needed_caps(intermediate, planned))

        if cache is not None:
            cache.record(decision)
        self.last_plan = planned

        # ---- Close the Q||C_max feedback loop: this batch's wave timings
        # (measured per-slot clocks on the sharded backend, synthetic on the
        # stacked one) update the speed estimate the next plan uses.
        self.last_wave_timings = timings
        if timings is not None:
            self._observe_measured(timings, planned)
        else:
            self._observe_wave_timings(planned, key_dist)

        # Each cluster is reduced on exactly one slot, so the merge is a
        # sum over slots (done on the pulled float32 arrays; the
        # checkpointed walk merged wave by wave and counts no wire bytes,
        # as the reference's).
        acct, inexact = {}, 0
        if checkpointing:
            values, counts_np = results
        else:
            values, counts_np = self._host_merge(results)
            wire = self._gather([r[3][None] for r in results]).sum(dim=0)
            acct = self._wire_accounting(wire, self._as_groups(intermediate)[0][1],
                                         planned.waves.replication)
            self._last_wire = (acct["shuffle_bytes"], acct["shuffle_pairs"])
            inexact = acct.pop("inexact")
        self._spans.phase(None)
        self.last_phase_ms, self.last_spans = self._spans.finish()

        # One Map operation per shard (paper footnote 1: Map task == operation).
        net = clustering.network_cost_bytes(
            num_map_ops=m, num_clusters=n, num_tasktrackers=m, num_reduce_tasks=m
        )
        return JobResult(
            values=values,
            counts=counts_np,
            schedule=planned.schedule,
            key_distribution=key_dist,
            overflow=overflow_total,
            network_cost=net,
            strategy=planned.strategy,
            strategy_costs=planned.strategy_costs,
            reused=bool(decision is not None and decision.action == "reuse"),
            plan_reason=decision.reason if decision is not None else "",
            drift=decision.drift if decision is not None else None,
            replan_benefit=benefit,
            slot_speeds=planned.schedule.slot_speeds,
            speed_drift=decision.speed_drift if decision is not None else None,
            quantize_exact=(inexact == 0) if cfg.quantize_shuffle else None,
            bucket_rows=self._run_bucket_rows,
            **acct,
        )


# Slot streams, kept for the process per (device, slot): a new sharded job
# reuses the streams of the jobs before it, and with them the caching
# allocator's per-stream memory pools, instead of growing cold pools.
_SLOT_STREAMS: dict = {}


def _slot_stream(device: torch.device, slot: int) -> torch.cuda.Stream:
    """Slot ``slot``'s CUDA stream on ``device`` (made at first use)."""
    key = (device, slot)
    if key not in _SLOT_STREAMS:
        _SLOT_STREAMS[key] = torch.cuda.Stream(device=device)
    return _SLOT_STREAMS[key]


def _slot_slice(inputs, slot: int, device):
    """Slot ``slot``'s ``(1, ...)`` slice of every tensor in ``inputs`` (a
    tensor, or tuples, lists and dicts of them), on ``device``."""
    if isinstance(inputs, torch.Tensor):
        return inputs[slot:slot + 1].to(device)
    if isinstance(inputs, (tuple, list)):
        return type(inputs)(_slot_slice(x, slot, device) for x in inputs)
    if isinstance(inputs, dict):
        return {k: _slot_slice(v, slot, device) for k, v in inputs.items()}
    return inputs
