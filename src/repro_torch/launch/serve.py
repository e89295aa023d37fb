"""Serving driver of the port: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Two modes:

* default — the continuous-batching engine (OS4M lane scheduling) on
  synthetic requests with the arch's smoke twin; reports lane balance and
  throughput for os4m vs the hash baseline. As in the reference's
  launcher no patches or frames are built: qwen2-vl-7b serves text only,
  and whisper-base fails in its first prefill (``AttributeError``: no
  frames), as the reference's does.
* ``--steady-state N`` — the MapReduce serving loop: ONE persistent
  :class:`~repro_torch.core.mapreduce.MapReduceJob` with a
  :class:`~repro_torch.core.schedule_cache.ReusePolicy` runs N batches of a
  stationary workload (with an optional injected distribution shift),
  amortizing a single host plan over the whole steady state. Reports the
  replan rate, per-batch wall time, and drift telemetry — the serving-
  scale deployment story of ROADMAP.md.

Heterogeneity knobs (both modes): ``--slot-slowdown i:factor`` injects a
straggler — the factor is a **wall-clock multiplier**: slot/lane ``i``
takes ``factor``× the nominal time (``3:2`` makes slot 3 twice as slow;
``3:0.5`` twice as fast). In steady-state mode the job's online speed
estimator detects it from wave timings and replans (``speed_drift``); in
engine mode the lane is admitted proportionally less decode work
(relative speed ``1/factor``). ``--schedule-snapshot p.json``
warm-starts the steady-state job from a persisted
:class:`~repro_torch.core.schedule_cache.CachedSchedule` (skipping the cold
replan); ``--save-snapshot p.json`` writes the final plan back.

Elastic mesh (steady-state): ``--slot-slowdown i:0`` declares slot ``i``
dead before the run; ``--checkpoint-waves`` persists phase-B progress at
wave granularity; ``--kill-at-wave i:w`` kills slot ``i`` mid-batch just
before wave ``w`` — only the unfinished waves replay on the survivors,
and outputs stay bit-identical to an uninterrupted run. Every mesh event
(a death, a join, a resize) is printed as it happens. In engine mode
``--slot-slowdown i:0`` is a dead lane, as in the reference.

Timing source (steady-state): ``--backend shard_map`` maps to the port's
``backend="sharded"``: one program and CUDA stream per Reduce slot (``m``
copies of the current CUDA device, or ``["cpu"] * m`` with ``--device
cpu``), and the job then feeds the estimator *measured* per-slot phase-B
wave clocks instead of the synthetic model (the ``%globaltimer`` stamps
of ``kernels/wave_timer``); injected slowdowns scale the measured seconds.

Device: ``--device`` (default ``cuda``) is where the model, the cache and
the MapReduce slots live; ``--device cpu`` runs every kernel's plain
version on the CPU.
Engine mode: ``--replan-on-drift`` turns on adaptive lane metering AND
mid-run replanning of the waiting queues when a lane's measured speed
drifts (``Engine.maybe_replan_waiting``). ``--attn-impl`` (default
``pallas``: the hand-written flash-attention kernel on CUDA, its plain
version on the CPU) sets the smoke twin's prefill attention; the summary
line ends with the flash kernel's launch count (0 on the CPU).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple


def steady_state_loop(
    job,
    batches: Iterable,
    on_batch: Optional[Callable[[int, Any, float], None]] = None,
) -> Dict[str, Any]:
    """Serve ``batches`` through one persistent job, amortizing the plan.

    ``job`` is a :class:`~repro_torch.core.mapreduce.MapReduceJob`,
    normally configured with ``reuse=ReusePolicy(...)`` so the host
    scheduler runs only on drift/age events; the loop itself is
    policy-agnostic (pass a no-reuse job to measure the always-replan
    baseline). ``on_batch`` is called as ``on_batch(index, result,
    wall_seconds)`` after each batch.

    Returns telemetry: per-batch ``walls``/``reused``/``reasons``/
    ``drifts`` and the job's ``schedule_cache`` counters (when reuse is
    on). The reference's ``jit_misses`` has no counterpart: nothing is
    compiled per batch here.
    """
    walls: List[float] = []
    reused: List[bool] = []
    reasons: List[str] = []
    drifts: List[Optional[float]] = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        res = job.run(batch)
        wall = time.perf_counter() - t0
        walls.append(wall)
        reused.append(res.reused)
        reasons.append(res.plan_reason)
        drifts.append(res.drift)
        if on_batch is not None:
            on_batch(i, res, wall)
    out: Dict[str, Any] = {
        "batches": len(walls),
        "walls": walls,
        "reused": reused,
        "reasons": reasons,
        "drifts": drifts,
    }
    if job.schedule_cache is not None:
        out["cache"] = job.schedule_cache.stats()
    return out


def parse_slowdowns(specs: Optional[List[str]]) -> List[Tuple[int, float]]:
    """Parse repeated ``--slot-slowdown i:factor`` flags into (slot, factor).

    The factor is a wall-clock multiplier (2 = twice as slow), matching
    :meth:`repro_torch.core.mapreduce.MapReduceJob.set_slot_slowdown`. A
    factor of exactly ``0`` declares the slot/lane **dead**: it is then
    planned nothing.
    """
    out: List[Tuple[int, float]] = []
    for spec in specs or []:
        try:
            slot_s, factor_s = spec.split(":", 1)
            slot, factor = int(slot_s), float(factor_s)
        except ValueError as exc:
            raise SystemExit(
                f"--slot-slowdown expects i:factor (e.g. 3:2), got {spec!r}"
            ) from exc
        if factor < 0:
            raise SystemExit(
                f"--slot-slowdown factor must be >= 0 (0 = dead slot), "
                f"got {factor}")
        out.append((slot, factor))
    return out


def parse_kills(specs: Optional[List[str]]) -> List[Tuple[int, int]]:
    """Parse repeated ``--kill-at-wave i:w`` flags into (slot, wave).

    Arms a mid-batch fault injection: slot ``i`` dies just before phase-B
    wave ``w`` of the first batch executes (the reference's
    :meth:`repro_torch.core.mapreduce.MapReduceJob.set_slot_failure` with
    ``at_wave``). Requires ``--checkpoint-waves``.
    """
    out: List[Tuple[int, int]] = []
    for spec in specs or []:
        try:
            slot_s, wave_s = spec.split(":", 1)
            slot, wave = int(slot_s), int(wave_s)
        except ValueError as exc:
            raise SystemExit(
                f"--kill-at-wave expects i:w (e.g. 3:2), got {spec!r}"
            ) from exc
        if wave < 0:
            raise SystemExit(f"--kill-at-wave wave must be >= 0, got {wave}")
        out.append((slot, wave))
    return out


def _steady_state_main(args) -> None:
    """The ``--steady-state`` mode: MapReduce serving with schedule reuse."""
    import numpy as np
    import torch

    from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob
    from repro_torch.core.schedule_cache import ReusePolicy
    from repro_torch.kernels.wave_timer import ops as wt_ops

    slots, K, n = args.lanes, 4096, 64
    slowdowns = parse_slowdowns(args.slot_slowdown)
    kills = parse_kills(args.kill_at_wave)
    if kills and not args.checkpoint_waves:
        raise SystemExit("--kill-at-wave requires --checkpoint-waves")
    device = torch.device(args.device)

    def make_batch(seed: int, alpha: float):
        rng = np.random.default_rng(seed)
        keys = (rng.zipf(alpha, size=(slots, K)) % 2003).astype(np.int32)
        vals = np.ones((slots, K, 4), np.float32)
        valid = np.ones((slots, K), bool)
        return tuple(torch.as_tensor(a, device=device) for a in (keys, vals, valid))

    def batches():
        for i in range(args.steady_state):
            drifted = args.drift_at >= 0 and i >= args.drift_at
            yield make_batch(i, 1.9 if drifted else 1.25)

    if args.backend == "shard_map":
        where = {"backend": "sharded",
                 "devices": ["cpu"] * slots if device.type == "cpu" else None}
    else:
        where = {"device": device}
    job = MapReduceJob(
        lambda s: s,
        MapReduceConfig(
            num_slots=slots, num_clusters=n, scheduler=args.scheduler,
            # Stragglers are detected online from wave timings — measured
            # per-slot clocks on the sharded backend (estimation always on
            # there: real slots can be genuinely slow without any
            # injection), synthetic slowdown-driven timings when stacked.
            estimate_speeds=bool(slowdowns) or args.backend == "shard_map",
            # Wave checkpointing owns the fenced program structure, so it
            # pins the synthetic timing model (measured mode is the other
            # owner; the two are mutually exclusive by construction).
            measure_timings=False if args.checkpoint_waves else None,
            checkpoint_waves=args.checkpoint_waves,
            stats=args.stats,
            stream_prefix=args.stream_prefix,
            reuse=ReusePolicy(max_drift=args.max_drift,
                              max_age=args.max_age,
                              revalidate_every=args.revalidate_every,
                              max_speed_drift=args.max_speed_drift),
        ),
        **where,
    )
    for slot, factor in slowdowns:
        if not 0 <= slot < slots:
            raise SystemExit(f"--slot-slowdown slot {slot} out of range "
                             f"[0, {slots})")
        job.set_slot_slowdown(slot, factor)
    for slot, wave in kills:
        if not 0 <= slot < slots:
            raise SystemExit(f"--kill-at-wave slot {slot} out of range "
                             f"[0, {slots})")
        job.set_slot_failure(slot, at_wave=wave)
    job.on_mesh_change = lambda ev: print(f"  mesh event: {ev}")
    if args.schedule_snapshot:
        with open(args.schedule_snapshot) as f:
            job.load_snapshot(json.load(f))
        print(f"warm start: loaded schedule snapshot {args.schedule_snapshot}")
    tele = steady_state_loop(
        job, batches(),
        on_batch=lambda i, res, w: print(
            f"  batch {i:3d}: {'reuse ' if res.reused else 'REPLAN'} "
            f"({res.plan_reason:11s}) drift="
            f"{'-' if res.drift is None else f'{res.drift:.3f}'} "
            f"wall={w * 1e3:.1f} ms"),
    )
    cache = tele["cache"]
    steady = [w for w, r in zip(tele["walls"], tele["reused"]) if r]
    print(f"\nsteady state: {cache['reuses']}/{cache['batches']} batches "
          f"reused one plan (replan rate {cache['replan_rate']:.2f}, "
          f"{cache['drift_checks']} drift checks, "
          f"{cache['speed_replans']} speed replans)")
    if steady:
        print(f"median reused-batch wall: {np.median(steady) * 1e3:.1f} ms")
    if args.checkpoint_waves and job.last_checkpoint_wave is not None:
        print(f"wave checkpoints: cursor {job.last_checkpoint_wave}, "
              f"{job.last_replayed_waves} waves replayed on the last batch"
              + (f", {len(job.mesh_events)} mesh events"
                 if job.mesh_events else ""))
    if slowdowns and job.speed_estimator is not None:
        est = job.speed_estimator.speeds()
        if est is not None:
            if job.last_wave_timings is not None:
                source = ("measured wave clocks, on-device ticks"
                          if wt_ops.backend(job.device) == "device"
                          else "measured wave clocks, host stamps")
            else:
                source = "synthetic timing model"
            print(f"estimated slot speeds ({source}): "
                  + " ".join(f"{s:.2f}" for s in est))
    if args.save_snapshot and job.schedule_cache.snapshot is not None:
        with open(args.save_snapshot, "w") as f:
            json.dump(job.schedule_cache.snapshot.to_json(), f)
        print(f"saved schedule snapshot -> {args.save_snapshot}")


def make_requests(cfg, count: int, max_len: int, jobs: int = 1, seed: int = 0):
    """The engine mode's synthetic requests, drawn with numpy from ``seed``:
    prompts of 4..23 tokens and Zipf(1.5)-skewed decode budgets (the
    operation-load skew of the paper's Fig 1a), round-robin over ``jobs``."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(count):
        plen = int(rng.integers(4, 24))
        budget = int(np.clip(rng.zipf(1.5) * 4, 4, max_len - plen - 2))
        reqs.append(Request(
            rid=i, prompt=rng.integers(3, cfg.vocab, plen).astype(np.int32),
            max_new=budget, job=i % max(jobs, 1)))
    return reqs


def main():
    """CLI entry point (see module docstring for the two modes)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--scheduler", default=None,
                    help="default: os4m (engine mode), auto (steady-state mode)")
    ap.add_argument("--steady-state", type=int, default=0, metavar="N",
                    help="serve N MapReduce batches through one reused plan")
    ap.add_argument("--backend", default="vmap",
                    choices=("vmap", "shard_map"),
                    help="steady-state mode: vmap = the stacked backend; "
                         "shard_map = the sharded backend (one program and "
                         "stream per slot) + measured per-slot phase-B timings")
    ap.add_argument("--device", default="cuda",
                    help="where the model, the cache and the slots live "
                         "(default cuda; cpu runs the plain versions)")
    ap.add_argument("--attn-impl", default="pallas",
                    choices=("pallas", "blocked", "naive"),
                    help="engine mode: prefill attention (pallas = the flash "
                         "kernel on CUDA, its plain version on the CPU)")
    ap.add_argument("--replan-on-drift", action="store_true",
                    help="engine mode: adaptive lane metering + mid-run "
                         "replan of waiting queues on measured speed drift")
    ap.add_argument("--drift-at", type=int, default=-1, metavar="K",
                    help="steady-state mode: shift the key distribution at batch K")
    ap.add_argument("--max-drift", type=float, default=0.15)
    ap.add_argument("--max-age", type=int, default=None)
    ap.add_argument("--revalidate-every", type=int, default=1)
    ap.add_argument("--max-speed-drift", type=float, default=0.25,
                    help="replan when a slot's measured speed moves this much")
    ap.add_argument("--slot-slowdown", action="append", metavar="I:FACTOR",
                    help="inject a straggler: slot/lane I takes FACTOR x the "
                         "nominal wall-clock (2 = twice as slow; repeatable, "
                         "e.g. 3:2; 0 = the slot/lane is DEAD)")
    ap.add_argument("--checkpoint-waves", action="store_true",
                    help="steady-state mode: persist phase-B progress at "
                         "wave granularity so a mid-batch slot death "
                         "replays only the unfinished waves")
    ap.add_argument("--kill-at-wave", action="append", metavar="I:W",
                    help="fault injection: slot I dies just before phase-B "
                         "wave W of the first batch (repeatable; requires "
                         "--checkpoint-waves)")
    ap.add_argument("--schedule-snapshot", default=None, metavar="PATH",
                    help="steady-state mode: warm-start from a persisted "
                         "CachedSchedule JSON (skips the cold replan)")
    ap.add_argument("--save-snapshot", default=None, metavar="PATH",
                    help="steady-state mode: write the final plan's "
                         "CachedSchedule JSON on exit")
    ap.add_argument("--jobs", type=int, default=1,
                    help="engine mode: spread the requests round-robin over "
                         "N job ids — admission becomes the R||C_max "
                         "multi-job path (weighted completion order, "
                         "per-job lane-speed rows)")
    ap.add_argument("--job-weights", default=None, metavar="W0,W1,...",
                    help="comma-separated ΣwC priority weight per job id "
                         "(default: all 1.0)")
    ap.add_argument("--max-concurrent-jobs", type=int, default=None,
                    metavar="K",
                    help="admit at most K jobs per plan wave; later jobs "
                         "queue strictly behind the earlier wave")
    ap.add_argument("--stats", default="exact", choices=("exact", "sketch"),
                    help="statistics layer: exact histograms, or count-min "
                         "sketch planning (steady-state mode: O(sketch) "
                         "plan inputs; engine mode: sketch-budgeted "
                         "admission). Outputs are bit-identical either way")
    ap.add_argument("--stream-prefix", type=float, default=None,
                    metavar="FRAC",
                    help="steady-state mode with --stats sketch: plan wave 1 "
                         "from a sketch of the first FRAC of each shard's "
                         "pairs, refine the tail waves when the rest lands")
    args = ap.parse_args()

    if args.steady_state > 0:
        if args.scheduler is None:
            args.scheduler = "auto"   # steady-state default: cost-model pick
        _steady_state_main(args)
        return
    if args.scheduler is None:
        args.scheduler = "os4m"
    if args.stream_prefix is not None:
        raise SystemExit("--stream-prefix applies to --steady-state mode "
                         "(MapReduce batches) only")

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import Engine, EngineConfig

    cfg = dataclasses.replace(get_smoke(args.arch), attn_impl=args.attn_impl)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu for the CPU path)")
    params = init_model(cfg, seed=0, device=device)
    reqs = make_requests(cfg, args.requests, args.max_len, args.jobs)

    job_weights = None
    if args.job_weights:
        ws = [float(w) for w in args.job_weights.split(",")]
        job_weights = {j: w for j, w in enumerate(ws)}

    lane_speeds = None
    slowdowns = parse_slowdowns(args.slot_slowdown)
    if slowdowns:
        lane_speeds = np.ones(args.lanes)
        for lane, factor in slowdowns:
            if not 0 <= lane < args.lanes:
                raise SystemExit(f"--slot-slowdown lane {lane} out of range")
            # Factor is a wall-clock multiplier; lane speed is its inverse
            # — and factor 0 is a dead lane (speed exactly 0.0).
            lane_speeds[lane] = 1.0 / factor if factor > 0 else 0.0
    eng = Engine(cfg, params, EngineConfig(
        lanes=args.lanes, max_len=args.max_len, scheduler=args.scheduler,
        lane_speeds=lane_speeds,
        adaptive=args.replan_on_drift,
        replan_on_drift=args.replan_on_drift,
        max_concurrent_jobs=args.max_concurrent_jobs,
        job_weights=job_weights,
        stats=args.stats), device=device)
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"scheduler={args.scheduler}: {len(done)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks/dt:.1f} tok/s), "
          f"lane balance ratio {eng.last_balance_ratio:.3f}, "
          f"finish ratio {eng.last_finish_ratio:.3f}"
          + (f", {eng.replans} mid-run replans" if args.replan_on_drift
             else "")
          + f", attn_impl={args.attn_impl}, flash kernel launches {fa_ops.launches}")
    if args.jobs > 1:
        for j in range(args.jobs):
            jd = [r for r in done if r.job == j]
            jt = sum(len(r.output) for r in jd)
            print(f"  job {j}: {len(jd)} requests, {jt} tokens, "
                  f"weight {job_weights.get(j, 1.0) if job_weights else 1.0}")


if __name__ == "__main__":
    main()
