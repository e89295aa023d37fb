"""Real analyzer targets: recorded phase-B programs and host plan objects.

**Recorded programs** (:func:`phase_b_targets`, read by the overlap and
determinism checkers). The analyzer never checks toy stand-ins: each
target is a recorded run (:mod:`repro_torch.analysis.op_graph`) of the
engine's *actual* phase-B bodies (``core.mapreduce._phase_b_body`` and
``_phase_b_coded``) at the reference's geometry, in every variant the
reference traces, under its names and flags:

* ``sequential`` (Hadoop-style single shot) and ``pipelined`` (the §4.4
  chunk walk); ``pipelined-kernels`` is the same program — the port has
  no ``use_kernels`` switch, its reduce is always kernel 2's wrapper;
* ``pipelined-int8``, the quantized uncoded wire (with its ``pmax``);
* ``coded-r2`` and ``coded-r2-int8``, the XOR-multicast wire;
* ``timed-sequential`` and ``timed-pipelined``: the measured executor's
  stamp hook threaded through the same body;
* ``checkpointed-wave-copy`` and ``checkpointed-wave-run``: the fenced
  wave's spill + copy (``MapReduceJob._wave_copy``) and its reduce + host
  merge, as ``_execute_checkpointed`` runs them;
* ``sharded-pipelined``: one slot's program on ``backend="sharded"``
  (the counterpart of the reference's ``shard_map-pipelined``).

The stacked targets record the program the stacked backend runs, whose
spill keeps the kept pairs as indices (``mr._Kept``) and whose copy
moves nothing; ``sharded-pipelined`` records the padded bucket file and
its copies between slots.
* ``phase-a-sketch``: phase A with the count-min provider, which carries
  no collective, host sync or wire sort.

Targets record on ``device="cpu"`` by default; any device records the same
programs (``chip_smoke.py`` records them on the card, where the kernels
launch, and holds each one's prims to the CPU recording's).

**Plan targets** (:func:`plan_targets`, read by the plan checker): what
:meth:`MapReduceJob._plan` (or the streaming-prefix
:meth:`MapReduceJob._plan_prefixed`) returns on synthetic-but-realistic
statistics — the reference's eight configurations and seeds: an LPT plan,
a pipelined BSS plan, a straggler (Q||C_max) plan, a dead-slot plan, a
coded r=2 plan, and the sketch-statistics plans (pure count-min and the
streaming-prefix two-step) whose snapshots exercise the validator's
overestimate-aware capacity rules. Planning is host work: the jobs are
made on the CPU and run nothing on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import op_graph as og
from repro_torch.core import mapreduce as mr
from repro_torch.core import schedule_cache as sc

# One small-but-structured geometry shared by every recorded variant (the
# reference's): m slots, n operation clusters, k pairs per shard, v-dim
# values, C pipeline chunks with per-chunk send caps.
M, N_CLUSTERS, K_PAIRS, V_DIM, CHUNKS = 4, 8, 32, 3, 4
CHUNK_CAPS: Tuple[int, ...] = (16, 16, 16, 16)
CAPACITY = 32
SEED = 0


@dataclasses.dataclass
class TracedTarget:
    """One recorded phase-B program + the flags the checkers dispatch on.

    ``result`` is what the recorded run returned (its outputs, for the
    bit-equality check against an unrecorded run)."""

    name: str
    graph: og.OpGraph
    timed: bool = False
    coded: bool = False
    pipelined: bool = False
    result: object = None


def shard_inputs(device, seed: int = SEED):
    """Seeded phase-B inputs of every slot: ``(key_hashes (M, K) int32,
    values (M, K, V) float32, valid (M, K) bool)`` and the plan tensors
    ``(assignment, rank_of_cluster, chunk_of_cluster)``, int32, on ``device``."""
    rng = np.random.default_rng(seed)
    kh = rng.integers(0, 2 ** 31 - 1, (M, K_PAIRS), dtype=np.int64).astype(np.int32)
    vals = rng.standard_normal((M, K_PAIRS, V_DIM)).astype(np.float32)
    valid = rng.random((M, K_PAIRS)) < 0.9
    assignment = rng.integers(0, M, N_CLUSTERS).astype(np.int32)
    rank = rng.permutation(N_CLUSTERS).astype(np.int32)
    chunk = (rank // (N_CLUSTERS // CHUNKS)).astype(np.int32)
    inter = tuple(torch.from_numpy(a).to(device) for a in (kh, vals, valid))
    plan = tuple(torch.from_numpy(a).to(device) for a in (assignment, rank, chunk))
    return inter, plan


def static_of(pipelined: bool, quantize: Optional[str] = None) -> Tuple:
    """The engine's phase-B ``static`` tuple for one variant."""
    chunks = CHUNKS if pipelined else 1
    caps = CHUNK_CAPS if pipelined else (CAPACITY,)
    return (M, N_CLUSTERS, CAPACITY, caps, "sum", pipelined, chunks, quantize)


def record(name: str, program: Callable, **flags) -> TracedTarget:
    """Record ``program(rec)`` (which returns the program's outputs)."""
    with og.Recorder() as rec:
        result = program(rec)
        rec.set_outputs(result)
    return TracedTarget(name, rec.graph, result=result, **flags)


def _phase_b(static, device, coded: bool = False, timed: bool = False, body=None):
    """The program of all stacked slots under ``static``: the engine's body
    (or ``body``, a mutant with its signature), tapped, driven by the
    engine's own runner."""
    inter, plan = shard_inputs(device)

    def program(rec):
        if coded:
            gen = mr._phase_b_coded(inter, *plan, static, list(range(M)))
        else:
            me = torch.arange(M, device=device)
            make = body or mr._phase_b_body
            gen = make(inter, *plan, static, me, og.stamp_hook(rec) if timed else None)
        return mr._drive_stacked(og.tapped(rec, gen))

    return program


def _checkpointed_wave(device) -> List[TracedTarget]:
    """The fenced wave of ``_execute_checkpointed``: a spill and the copy of
    wave 1 (``MapReduceJob._wave_copy``), then that wave's reduce and its
    host merge (the fence)."""
    cfg = mr.MapReduceConfig(num_slots=M, num_clusters=N_CLUSTERS, pipeline_chunks=CHUNKS,
                             checkpoint_waves=True)
    job = mr.MapReduceJob(lambda s: s, cfg, device=device)
    inter, plan = shard_inputs(device)
    static = static_of(True)
    me = torch.arange(M, device=device)
    spilled = []

    def copy_program(rec):
        send, overflow, rows = mr._spill(inter, *plan, static, me, inter[1], inter[1])
        spilled.append(rec.collective("spill", lambda s: s, send))
        return job._wave_copy(0, spilled, [None], 1)

    copied = record("checkpointed-wave-copy", copy_program, pipelined=True)

    def run_program(rec):
        seg = copied.result.clone()
        out, counts = mr._reduce_received(spilled[0], seg, plan, N_CLUSTERS, "sum")
        job._host_merge([(out, counts)])
        return out, counts

    return [copied, record("checkpointed-wave-run", run_program, pipelined=True)]


def _sharded(device) -> TracedTarget:
    """Slot 0's program of a pipelined phase B on ``backend="sharded"``."""
    cfg = mr.MapReduceConfig(num_slots=M, num_clusters=N_CLUSTERS, pipeline_chunks=CHUNKS)
    job = mr.MapReduceJob(lambda s: s, cfg, backend="sharded", devices=[device] * M)
    inter, plan = shard_inputs(device)
    static = static_of(True)

    def program(rec):
        bodies = []
        for j in range(M):
            with rec.suspended(), job._on_slot(j):
                part = tuple(t[j:j + 1].clone() for t in inter)
                me = torch.tensor([j], device=device)
            bodies.append(mr._phase_b_body(part, *plan, static, me))
        bodies[0] = og.tapped(rec, bodies[0])
        with og.one_slot(rec, job, 0):
            return job._drive_sharded(bodies)[0]

    return record("sharded-pipelined", program, pipelined=True)


def _phase_a_sketch(device) -> TracedTarget:
    """Phase A with the count-min provider: map + sketch collection."""
    from repro_torch.core import stats_provider as sp

    provider = sp.SketchStats(N_CLUSTERS, width=64, depth=3)
    inter, _ = shard_inputs(device)

    def program(rec):
        (kh, _vals, _valid), state = mr._phase_a(inter, lambda s: s, N_CLUSTERS,
                                                 provider.collect)
        return state, kh

    return record("phase-a-sketch", program)


def phase_b_targets(device="cpu") -> List[TracedTarget]:
    """Every real phase-B variant, recorded and graphed on ``device``."""
    device = torch.device(device)
    out = []
    for name, static, flags in (
            ("sequential", static_of(False), {}),
            ("pipelined", static_of(True), {"pipelined": True}),
            ("pipelined-kernels", static_of(True), {"pipelined": True}),
            ("pipelined-int8", static_of(True, "int8"), {"pipelined": True}),
            ("coded-r2", static_of(True), {"pipelined": True, "coded": True}),
            ("coded-r2-int8", static_of(True, "int8"), {"pipelined": True, "coded": True}),
            ("timed-sequential", static_of(False), {"timed": True}),
            ("timed-pipelined", static_of(True), {"pipelined": True, "timed": True})):
        out.append(record(name, _phase_b(static, device, coded=flags.get("coded", False),
                                         timed=flags.get("timed", False)), **flags))
    out.extend(_checkpointed_wave(device))
    out.append(_sharded(device))
    out.append(_phase_a_sketch(device))
    return out


def plan_for(cfg: mr.MapReduceConfig, seed: int) -> sc.CachedSchedule:
    """The planner's snapshot of ``cfg`` on a seeded ``(m, n)`` histogram."""
    job = mr.MapReduceJob(lambda s: s, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, 64, size=(cfg.num_slots, cfg.num_clusters))
    hist = hist.astype(np.float64)
    k_per_shard = int(np.ceil(hist.sum(axis=1).max()))
    if cfg.stats == "sketch":
        # The planner consumes provider state — sketch the synthetic
        # histogram (count-min is linear, so from_dense == collect).
        state = job._stats.from_dense(hist)
        if cfg.stream_prefix is not None:
            # Prefix state: a thinner sample of the same distribution,
            # as the first stream_prefix of pairs would produce.
            noise = rng.uniform(0.5, 1.5, size=hist.shape)
            prefix = np.floor(hist * cfg.stream_prefix * noise)
            return job._plan_prefixed(
                state, job._stats.from_dense(prefix), k_per_shard)
        return job._plan(state, None, k_per_shard)
    return job._plan(hist, hist.sum(axis=0), k_per_shard)


def plan_targets() -> List[Tuple[str, sc.CachedSchedule]]:
    """Real planner outputs across scheduler / speed / coding variants."""
    cfg = mr.MapReduceConfig
    return [
        ("lpt-uniform", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt"),
                                 seed=0)),
        ("os4m-pipelined", plan_for(cfg(num_slots=4, num_clusters=12, scheduler="os4m",
                                        pipeline_chunks=3), seed=1)),
        ("lpt-straggler", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt",
                                       speeds=(1.0, 0.5, 1.0, 2.0)), seed=2)),
        ("lpt-dead-slot", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt",
                                       speeds=(1.0, 1.0, 0.0, 1.0)), seed=3)),
        ("coded-r2", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt",
                                  shuffle_replication=2), seed=4)),
        ("sketch-os4m", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="os4m",
                                     stats="sketch", sketch_width=64, sketch_depth=3),
                                 seed=5)),
        ("sketch-lpt", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt",
                                    stats="sketch", sketch_width=32, sketch_depth=4),
                                seed=6)),
        ("sketch-prefix", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt",
                                       stats="sketch", sketch_width=64, sketch_depth=3,
                                       stream_prefix=0.25), seed=7)),
    ]
