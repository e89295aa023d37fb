"""A keyed Map/Shuffle/Reduce engine on one GPU with OS4M scheduling.

The paper's whole workflow —

    map  →  collect per-key statistics  →  (host) Q||C_max schedule
         →  chunked shuffle ("copy")    →  pipelined segment reduce ("run")

as two device phases around a host planning step. Phase boundaries match
the paper: Reduce work begins only after *all* Map operations have
finished and the schedule is known (§4.1 step 6).

The ``m`` Reduce slots are a leading ``(m,)`` axis of every tensor on one
device — the stacked-slots form of the reference's ``backend="vmap"``.
The all-to-all "copy" of a chunk is then a transpose of its ``(src, dst,
cap)`` bucket tensor, and the reference's ``psum`` over slots is a sum
over that axis.

Phase A maps the input and builds every slot's ``K^(i)`` histogram in one
launch of the histogram kernel. The host pulls the ``(m, n)`` float32
statistics and plans: the schedule, the §4.4 waves (chunks of clusters in
increasing-load order) and the statistics-sized send capacities. Phase B
writes every chunk's bucket file in one counting-sort spill, then walks
the chunks: the "copy" of chunk ``c+1`` is issued before the reduce of
chunk ``c``, and each chunk's "sort" + "run" is one launch of the fused
gather + segment-sum kernel over all slots, on pairs ordered by pipeline
rank. Sums accumulate in float32 (the CUDA kernel takes float32 values).

On CUDA tensors the two kernels run; on CPU tensors their plain PyTorch
versions run, with the same semantics — the reference's
``use_kernels=True`` path either way, so the tests hold the port against
the reference on the CPU.

Data model: ``map_fn(inputs)`` returns stacked tensors ``(key_hashes (m,
K) int32, values (m, K, V) float, valid (m, K) bool)``: up to ``K``
intermediate pairs per slot. Keys are pre-hashed by the user's map
function.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import clustering
from repro_torch.core import pipeline as pipe
from repro_torch.core import schedule_cache as sc
from repro_torch.core import scheduler as sched_lib
from repro_torch.core import stats_provider as sp
from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops

__all__ = ["MapReduceConfig", "JobResult", "MapReduceJob"]

_INT32_MIN = -(2 ** 31)
REDUCE_OPS = ("sum", "max", "count")


@dataclasses.dataclass(frozen=True)
class MapReduceConfig:
    """Static configuration of one :class:`MapReduceJob`.

    Heterogeneous slots (Q||C_max): ``speeds`` pins a known per-slot
    relative speed vector. Speeds only move *where* clusters are reduced
    — outputs are bit-identical under any speed vector.

    The fields after ``speeds`` name features of the reference that the
    port does not have yet; any value but the default raises
    ``NotImplementedError`` naming the ROADMAP Queue 1 item that brings it.
    """

    num_slots: int                      # m — Reduce slots
    num_clusters: int                   # n — operation clusters (§4.3)
    scheduler: str = "os4m"             # hash | lpt | multifit | bss | os4m
    eta: float = 0.002                  # FPTAS precision (paper §5: 0.2%)
    reduce_op: str = "sum"              # sum | max | count
    pipeline_chunks: int = 4            # Reduce pipeline granularity (§4.4)
    pipelined: bool = True              # False = Hadoop-style single-shot phase B
    capacity_send: Optional[int] = None  # per-(shard,dest) send buffer; None = safe bound
    speeds: Optional[Tuple[float, ...]] = None  # static per-slot speeds (1.0 = nominal)
    reuse: Optional[Any] = None         # schedule reuse (item 4)
    estimate_speeds: bool = False       # online speed estimation (item 6)
    measure_timings: Optional[bool] = None  # measured wave clocks (item 6)
    checkpoint_waves: bool = False      # elastic mesh (item 7)
    shuffle_replication: int = 1        # coded shuffle (item 8)
    quantize_shuffle: Optional[str] = None  # quantized wire (item 8)
    stats: str = "exact"                # count-min statistics (item 5)
    stream_prefix: Optional[float] = None   # streaming-prefix planning (item 5)


@dataclasses.dataclass
class JobResult:
    """Outputs + provenance of one ``run()``.

    The reference's fields that this slice can fill; those of features not
    ported yet (reuse, auto strategy costs, coded and quantized wire) come
    with their ROADMAP items.
    """

    values: np.ndarray          # (num_clusters, V) reduced outputs
    counts: np.ndarray          # (num_clusters,) pairs per cluster
    schedule: sched_lib.Schedule
    key_distribution: np.ndarray  # K = (k_1..k_n) (cluster loads, §4.1)
    overflow: int               # pairs dropped by capacity clamp (0 in normal runs)
    network_cost: clustering.NetworkCost
    strategy: str = ""          # scheduler used
    slot_speeds: Optional[np.ndarray] = None  # speeds the plan was built for
    # Bytes-on-the-wire of phase B's shuffle: rows counted on the device,
    # converted to bytes with the static row size (payload + 4-byte id).
    shuffle_bytes: Optional[int] = None   # a2a payload bytes
    shuffle_rows: Optional[int] = None    # wire rows behind those bytes
    shuffle_pairs: Optional[int] = None   # non-local pairs the wire carried


def _unported(cfg: MapReduceConfig):
    """The (setting, ROADMAP Queue 1 item) pairs of ``cfg`` the port lacks."""
    checks = [
        (cfg.scheduler == "auto", "scheduler='auto'", 4),
        (cfg.reuse is not None, "reuse", 4),
        (cfg.stats == "sketch", "stats='sketch'", 5),
        (cfg.stream_prefix is not None, "stream_prefix", 5),
        (cfg.estimate_speeds, "estimate_speeds", 6),
        (bool(cfg.measure_timings), "measure_timings=True", 6),
        (cfg.checkpoint_waves, "checkpoint_waves", 7),
        (cfg.shuffle_replication != 1, "shuffle_replication", 8),
        (cfg.quantize_shuffle is not None, "quantize_shuffle", 8),
    ]
    return [(name, item) for hit, name, item in checks if hit]


# ---------------------------------------------------------------------------
# Phase bodies over stacked slots (leading (m,) axis).
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


def _phase_a(inputs, map_fn: Callable, num_clusters: int, stats_fn: Callable):
    """Map + local statistics (paper §4.1 steps 1–3) for every slot.

    Returns ``((key_hashes, values, valid), state)``; ``state`` is the
    provider's ``(m, n)`` float32 statistics — the TaskTracker →
    JobTracker report of §4.1.
    """
    key_hashes, values, valid = map_fn(inputs)
    key_hashes = key_hashes.to(torch.int32)
    valid = valid.to(torch.bool)
    state = stats_fn(_cluster_ids(key_hashes, num_clusters), valid.to(torch.float32))
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


def _counting_sort_to_buckets(dest, values, payload, num_slots: int, capacity: int):
    """Bucket every slot's pairs by destination into ``(m, m, cap, ...)`` buffers.

    The "bucket file per operation cluster" layout of §4.4, bounded by
    the schedule's capacity: the uniform-capacity case of the ragged sort.
    """
    m = dest.shape[0]
    caps = np.full(num_slots, capacity, np.int64)
    bv, bc, bm, overflow = _ragged_counting_sort_to_buckets(
        dest, values, payload, caps, num_slots * capacity)
    return (bv.reshape(m, num_slots, capacity, values.shape[-1]),
            bc.reshape(m, num_slots, capacity),
            bm.reshape(m, num_slots, capacity), overflow)


def _wire_rows(bucket_valid: torch.Tensor) -> torch.Tensor:
    """Rows crossing the network: all bucketed rows but the ``(i, i)`` ones."""
    diag = bucket_valid.diagonal(dim1=0, dim2=1)
    return bucket_valid.sum() - diag.sum()


def _copy_chunk(buckets):
    """The "copy" of one chunk: slot ``j`` receives bucket ``[i, j]`` of every ``i``.

    ``(m_src, m_dst, cap, ...)`` → ``(m_dst, m_src · cap, ...)``: the
    all-to-all of the reference is a transpose on one device.
    """
    bv, bc, bm = buckets
    m, _, cap = bm.shape
    return (bv.transpose(0, 1).reshape(m, m * cap, bv.shape[-1]),
            bc.transpose(0, 1).reshape(m, m * cap),
            bm.transpose(0, 1).reshape(m, m * cap))


def _segment_sum(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``(m, R, W)`` rows summed by ``seg (m, R)`` in ``[0, S]`` → ``(m, S, W)``.

    Id ``S`` is the dump segment and is dropped.
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
    segment-sum kernel in one pass (float32 sums), and the result is
    un-permuted back to cluster ids with one gather. ``max`` / ``count``:
    :func:`_segment_reduce`. Also the whole of the sequential path's
    reduce: its input is one chunk holding every pair, and each cluster's
    pairs reach the kernel in the same relative order as in the pipelined
    walk, so both paths agree bit for bit.
    """
    if reduce_op != "sum":
        return _segment_reduce(rc, rv, rm, num_clusters, reduce_op)
    order, rank_sorted = _rank_order(rc, rm, rank_of_cluster, num_clusters)
    out_by_rank = fused_ops.fused_shuffle_reduce(rv, order, rank_sorted, num_clusters)
    out = out_by_rank[:, rank_of_cluster.long()]
    seg = torch.where(rm, rc.long(), num_clusters)
    counts = _segment_sum(rm.to(torch.float32)[..., None], seg, num_clusters)[..., 0]
    return out, counts


def _phase_b(intermediate, assignment, rank_of_cluster, chunk_of_cluster, static):
    """Chunked shuffle ("copy") + pipelined reduce ("run") — §4.1 step 6 + §4.4.

    ``pipelined=False`` (or a single chunk) is the Hadoop-style barrier:
    one bulk all-to-all of every pair, then one reduce. The pipelined path
    writes every chunk's bucket file in one spill and walks the chunks in
    increasing-load order, issuing the copy of chunk ``c+1`` before the
    reduce of chunk ``c`` — the reference's double-buffered order, which
    overlaps the two once the copy is a collective between devices.

    Returns ``(out (m, n, V), counts (m, n), overflow, wire_rows)``, the
    last two as device scalars.
    """
    (m, n, capacity, chunk_caps, reduce_op, pipelined, num_chunks) = static
    key_hashes, values, valid = intermediate
    v_dim = values.shape[-1]
    cluster_ids = _cluster_ids(key_hashes, n)
    cid = cluster_ids.long()

    if not pipelined or num_chunks <= 1:
        dest = torch.where(valid, assignment[cid], m).to(torch.int32)
        bv, bc, bm, overflow = _counting_sort_to_buckets(
            dest, values, cluster_ids, m, capacity)
        wire_rows = _wire_rows(bm)
        rv, rc, rm = _copy_chunk((bv, bc, bm))
        out, counts = _reduce_chunk(rv, rc, rm, rank_of_cluster, n, reduce_op)
        return out, counts, overflow, wire_rows

    # ---- Every chunk's bucket file in ONE counting-sort spill: groups are
    # (chunk, dest) pairs with statistics-derived capacities, laid out
    # chunk-major so each chunk's send buckets are a contiguous slab.
    group = torch.where(valid, chunk_of_cluster[cid] * m + assignment[cid],
                        num_chunks * m).to(torch.int32)
    group_caps = np.repeat(np.asarray(chunk_caps, np.int64), m)
    total = int(group_caps.sum())
    fv, fc, fm, overflow = _ragged_counting_sort_to_buckets(
        group, values, cluster_ids, group_caps, total)
    send = []
    wire_rows = torch.zeros((), dtype=torch.int64, device=values.device)
    off = 0
    for cap in chunk_caps:
        size = m * cap
        slab_m = fm[:, off:off + size].reshape(m, m, cap)
        send.append((fv[:, off:off + size].reshape(m, m, cap, v_dim),
                     fc[:, off:off + size].reshape(m, m, cap), slab_m))
        wire_rows = wire_rows + _wire_rows(slab_m)
        off += size

    # ---- Copy→run walk in increasing-load chunk order. Sums accumulate in
    # float32 (the fused kernel's output), max/count in the value dtype.
    acc_dtype = torch.float32 if reduce_op == "sum" else values.dtype
    acc = torch.zeros((m, n, v_dim), dtype=acc_dtype, device=values.device)
    cnt = torch.zeros((m, n), dtype=torch.float32, device=values.device)
    recv = _copy_chunk(send[0])
    for c in range(num_chunks):
        rv, rc, rm = recv
        if c + 1 < num_chunks:
            recv = _copy_chunk(send[c + 1])
        out_c, cnt_c = _reduce_chunk(rv, rc, rm, rank_of_cluster, n, reduce_op)
        # Every cluster lives in exactly one chunk, so merging is a
        # *replace* where this chunk saw data — correct for max (a
        # maximum() merge would clamp negative maxima at the zero init)
        # and equivalent to += for sum/count (out_c is 0 elsewhere).
        if reduce_op == "max":
            acc = torch.where(cnt_c[..., None] > 0, out_c.to(acc_dtype), acc)
        else:
            acc = acc + out_c.to(acc_dtype)
        cnt = cnt + cnt_c
    return acc, cnt, overflow, wire_rows


# ---------------------------------------------------------------------------
# The job orchestrator.
# ---------------------------------------------------------------------------


class MapReduceJob:
    """Two-phase OS4M job on one device. See the module docstring.

    ``map_fn(inputs) -> (key_hashes (m, K), values (m, K, V), valid (m,
    K))`` returns stacked tensors on ``device``. ``device=None`` means
    ``"cuda"`` and raises when no CUDA device is present; pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU.
    """

    def __init__(self, map_fn: Callable, config: MapReduceConfig, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MapReduceJob runs on CUDA unless told otherwise, and no CUDA"
                    " device is available; pass device='cpu' for the CPU path")
            device = "cuda"
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.map_fn = map_fn
        self.cfg = config
        missing = _unported(config)
        if missing:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(
                    f"{name} (ROADMAP Queue 1 item {item})" for name, item in missing))
        if config.reduce_op not in REDUCE_OPS:
            raise ValueError(
                f"unknown reduce_op {config.reduce_op!r}; use one of {REDUCE_OPS}")
        self._stats = sp.make_provider(config.stats, config.num_clusters)
        if config.speeds is not None:
            sched_lib.normalize_speeds(config.speeds, config.num_slots)
        # Host-clock milliseconds of the last run() per phase: "phase_a"
        # (map + statistics, ending with the statistics pull), "plan"
        # (host scheduler), "phase_b" (shuffle + reduce, ending with the
        # output pull). Each phase ends in a device→host copy, so on CUDA
        # the device work is inside its phase.
        self.last_phase_ms: Optional[dict] = None
        # The plan the last run() executed (telemetry for benches and tests).
        self.last_plan: Optional[sc.CachedSchedule] = None

    def current_speeds(self) -> Optional[np.ndarray]:
        """Speed vector the next plan will use (None ≡ all nominal)."""
        if self.cfg.speeds is None:
            return None
        return np.asarray(self.cfg.speeds, np.float64)

    # -- measured shuffle-volume accounting ----------------------------------

    @staticmethod
    def _wire_accounting(wire_rows: int, values) -> dict:
        """Convert the device row count into bytes (static row size).

        An uncoded, unquantized wire row carries the value payload plus a
        4-byte cluster id.
        """
        row_bytes = int(values.shape[-1]) * values.element_size() + 4
        return {
            "shuffle_bytes": wire_rows * row_bytes,
            "shuffle_rows": wire_rows,
            "shuffle_pairs": wire_rows,
        }

    # -- planning (the host "JobTracker" step) -------------------------------

    def _plan(self, local_hist: np.ndarray, key_dist: Optional[np.ndarray],
              k_per_shard: int) -> sc.CachedSchedule:
        """One host planning step: schedule + §4.4 waves + send capacities.

        Pure host computation from the per-shard ``(m, n)`` float32
        statistics, the reference's exact-statistics planner line for
        line. The returned :class:`~repro_torch.core.schedule_cache.
        CachedSchedule` fully determines phase B.
        """
        cfg = self.cfg
        m, n = cfg.num_slots, cfg.num_clusters
        speeds = self.current_speeds()
        provider = self._stats
        state = np.asarray(local_hist)
        # f32 integer-exactness guard on the raw device counters: a
        # saturated count voids the statistics-sized bounds, so all of
        # them fall back to the safe k_per_shard.
        raw_max = float(state.max()) if state.size else 0.0
        hist_exact = raw_max < sp.F32_EXACT_MAX
        dense_hist = state
        key_dist = (np.asarray(key_dist) if key_dist is not None
                    else provider.key_dist(state))

        # The JobTracker invokes the scheduling algorithm (§4.1 step 4),
        # assigning by earliest finish time under the per-slot speeds
        # (Q||C_max; None ≡ identical slots).
        strategy = cfg.scheduler
        scheduler = sched_lib.get_scheduler(cfg.scheduler)
        if cfg.scheduler == "hash":
            schedule = scheduler(key_dist, m, keys=np.arange(n), speeds=speeds)
        elif cfg.scheduler in ("bss", "os4m"):
            schedule = scheduler(key_dist, m, eta=cfg.eta, speeds=speeds)
        else:
            schedule = scheduler(key_dist, m, speeds=speeds)

        # Static capacity for the all-to-all: the per-(shard,dest) worst
        # case from the per-shard statistics — shard i sends dest d exactly
        # the pairs of d's clusters that i holds. Bounds are quantized
        # (≤12.5% slack) to a bounded alphabet of buffer shapes.
        capacity = cfg.capacity_send or k_per_shard

        def _quantize_cap(c: int) -> int:
            """Round up to ~1/8-octave steps: bounded cache-key alphabet."""
            c = max(1, int(c))
            if c <= 8:
                return c
            g = 1 << max(0, (c - 1).bit_length() - 3)
            return -(-c // g) * g

        def _send_bound(members) -> int:
            """max over (shard, dest) of pairs shard sends dest."""
            if not hist_exact:
                return k_per_shard      # saturated f32 counts: safe bound
            if len(members) == 0:
                return 1
            dests = schedule.assignment[members]
            worst = 0.0
            for i in range(m):
                per_dest = np.bincount(
                    dests, weights=dense_hist[i, members], minlength=m
                )
                worst = max(worst, float(per_dest.max()))
            return min(k_per_shard, _quantize_cap(int(np.ceil(worst))))

        all_members = np.arange(n)
        capacity = max(1, int(min(capacity, k_per_shard, _send_bound(all_members))))

        # Pipeline plan (§4.4): per-slot increasing-load waves merged into
        # job-wide chunks, globally ordered by finish time under the slot
        # speeds — see ``pipeline.plan_waves``.
        waves = pipe.plan_waves(key_dist, schedule.assignment, m,
                                cfg.pipeline_chunks, speeds=speeds)
        chunk_caps = [
            int(min(capacity, _send_bound(waves.chunk_members(ci))))
            for ci in range(waves.num_chunks)
        ]
        return sc.CachedSchedule(
            schedule=schedule,
            strategy=strategy,
            waves=waves,
            capacity=capacity,
            chunk_caps=tuple(int(c) for c in chunk_caps),
            local_hist=state,
            key_dist=np.asarray(key_dist),
            k_per_shard=int(k_per_shard),
            stats_provider=provider.kind,
            stats_params=provider.params(),
        )

    # -- execution (phase B under one plan) ----------------------------------

    def _execute(self, intermediate, planned: sc.CachedSchedule):
        """Run phase B under one plan (fresh or loaded); device results.

        Returns ``(out (m, n, V), counts (m, n), overflow, wire_rows)``.
        """
        cfg = self.cfg
        if planned.waves.replication != 1:
            raise NotImplementedError(
                "plans for the coded shuffle are not ported yet: ROADMAP"
                " Queue 1 item 8")
        static = (
            cfg.num_slots, cfg.num_clusters, planned.capacity,
            tuple(planned.chunk_caps), cfg.reduce_op, cfg.pipelined,
            planned.waves.num_chunks,
        )
        dev = self.device
        return _phase_b(
            intermediate,
            torch.as_tensor(planned.schedule.assignment, dtype=torch.int32, device=dev),
            torch.as_tensor(planned.waves.rank_of_cluster, dtype=torch.int32, device=dev),
            torch.as_tensor(planned.waves.chunk_of_cluster, dtype=torch.int32, device=dev),
            static,
        )

    # -- public API ----------------------------------------------------------

    def run(self, inputs) -> JobResult:
        """Execute the full job: phase A → host plan → phase B."""
        cfg = self.cfg
        m, n = cfg.num_slots, cfg.num_clusters
        t0 = time.perf_counter()

        # ---- Phase A: map + statistics (all Maps finish before any Reduce).
        intermediate, local_k = _phase_a(inputs, self.map_fn, n, self._stats.collect)
        for t in intermediate:
            if t.device != self.device:
                raise ValueError(
                    f"map_fn returned a tensor on {t.device}; this job runs on"
                    f" {self.device}")
        if intermediate[0].shape[0] != m:
            raise ValueError(
                f"map_fn returned {intermediate[0].shape[0]} slots, config has {m}")
        # The planner reads the (m, n) float32 statistics as pulled — no
        # dtype cast, so ties break as in the reference.
        local_hist = local_k.reshape(m, -1).cpu().numpy()
        t1 = time.perf_counter()

        # ---- Host plan.
        provider = self._stats
        key_dist = provider.key_dist(local_hist)
        k_per_shard = int(intermediate[0].shape[-1])
        planned = self._plan(local_hist, key_dist, k_per_shard)
        self.last_plan = planned
        t2 = time.perf_counter()

        # ---- Phase B; each cluster is reduced on exactly one slot, so the
        # merge is a sum over slots (done on the pulled float32 arrays).
        out, counts, overflow, wire_rows = self._execute(intermediate, planned)
        values = out.cpu().numpy().reshape(m, n, -1).sum(axis=0)
        counts_np = counts.cpu().numpy().reshape(m, n).sum(axis=0)
        overflow_total = int(overflow)
        acct = self._wire_accounting(int(wire_rows), intermediate[1])
        t3 = time.perf_counter()
        self.last_phase_ms = {
            "phase_a": (t1 - t0) * 1e3,
            "plan": (t2 - t1) * 1e3,
            "phase_b": (t3 - t2) * 1e3,
        }

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
            slot_speeds=planned.schedule.slot_speeds,
            **acct,
        )
