"""Continuous-batching serving engine with OS4M lane scheduling.

Requests are Reduce operations (load = prompt + remaining decode budget);
KV-cache lanes are slots. Admission solves the same Q||C_max the
scheduler core solves for Reduce tasks: lanes balanced *by finish time*
mean no lane idles while another still has a deep queue — and a lane on a
slow device (or with a configured handicap) is handed proportionally less
decode work. Lane speeds come from ``EngineConfig.lane_speeds`` (explicit
/ fault injection) or, with ``adaptive=True``, from the measured per-lane
decode throughput (EWMA over completed steps,
:class:`repro_torch.core.slot_speeds.SlotSpeedEstimator`). Stragglers are
otherwise handled the OS4M way — a periodic *global* replan of the
waiting queue — not SkewTune-style migration of running work (migrating a
running lane would re-copy its KV cache, the 30-second-class cost the
paper's §7 argues against).

Mechanics: one shared cache for all lanes with **per-lane write
positions** (vector ``cache_pos``), so lanes decode in lock-step while
being at different sequence depths — true continuous batching. Admission
prefills a lane and splices its rows into the shared cache.

This is the port of the reference's ``repro.serve.engine``: the same
requests, plans, queues and greedy token streams. The decode step runs
eagerly (the reference jits it); each step writes the shared cache in
place, and a prefill, which runs the prompt on every lane as the
reference's does, works on a copy of which one lane is spliced back. The
engine runs on one device, CUDA unless the caller names another.

Scope: attention-family caches (batch axis 1 by construction —
dense/moe/vlm/whisper, MLA's compressed cache included). ``run(requests,
extra_embed=...)`` hands a vlm config's patch embeddings or whisper's
frame embeddings, ``(lanes, P, d)``, to every prefill, as the reference's
engine does; decoding continues at the prompt's length (the reference's
``pos[lane] = p``, which for a vlm stream of ``n_patches + p`` tokens
lies inside the patch block). SSM/hybrid serving uses the state-based
decode directly (examples/), and is not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import scheduler as sched_lib
from repro_torch.core import simulator as sim
from repro_torch.core import stats_provider as sp
from repro_torch.core.slot_speeds import SlotSpeedEstimator, speed_drift
from repro_torch.device import default_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward, init_cache

__all__ = ["Request", "EngineConfig", "Engine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    output: Optional[List[int]] = None
    lane: int = -1
    job: int = 0                  # owning job/tenant id (multi-job serving)

    @property
    def load(self) -> float:
        """Operation load: decode steps dominate lane occupancy."""
        return float(self.max_new + 0.1 * self.prompt.shape[0])


@dataclasses.dataclass
class EngineConfig:
    lanes: int = 8                # concurrent sequences (batch)
    max_len: int = 256            # lane KV capacity
    scheduler: str = "os4m"       # os4m | lpt | hash (eq. 3-1 baseline)
    eos: int = 2
    # Q||C_max lane admission: explicit relative lane speeds (fault
    # injection / known-heterogeneous devices), and/or adaptive weighting
    # by measured decode throughput. None + adaptive=False ≡ P||C_max.
    lane_speeds: Optional[Sequence[float]] = None
    adaptive: bool = False        # learn lane speeds from decode timings
    speed_ewma: float = 0.4       # EWMA weight of the newest measurement
    # Mid-run replanning (the OS4M answer to a lane slowing mid-serve):
    # with adaptive metering on, the decode loop periodically folds the
    # measured lane throughput into the meter and, when any lane's speed
    # moved more than max_speed_drift from the speeds the queues were
    # planned under, re-plans the WAITING queues globally — running
    # requests stay put (migrating a running lane would re-copy its KV
    # cache, the §7 cost the paper argues against).
    replan_on_drift: bool = False
    max_speed_drift: float = 0.25
    replan_check_every: int = 8   # decode steps between drift checks
    # Elastic mesh observer: called with one event dict per lane
    # join/leave/death ({"event": "lane_dead" | "lane_join", "lane": i,
    # "alive": k}) — the serve-side mirror of MapReduceJob.on_mesh_change.
    # The engine keeps the full log in ``Engine.mesh_events`` either way.
    on_mesh_change: Optional[Callable[[dict], None]] = None
    # Multi-job serving (R||C_max admission): requests carry a ``job`` id;
    # each job gets its own lane-speed row (per-job decode metering — the
    # engine's slice of the multi-job R-matrix), jobs are admitted in
    # weighted-completion-time order (Smith's rule, weight from
    # ``job_weights``, default 1.0), and at most ``max_concurrent_jobs``
    # jobs are interleaved on the lanes at once (None = no cap). Dead
    # lanes stay excluded from every job's row.
    max_concurrent_jobs: Optional[int] = None
    job_weights: Optional[Dict[int, float]] = None
    # Statistics source for admission planning (the serve-side mirror of
    # MapReduceConfig.stats): "exact" plans lanes from each request's
    # true load; "sketch" budgets lanes from a count-min estimate of the
    # waiting queue (core/stats_provider.CountMinParams) — estimates are
    # overestimate-only, so a lane's planned finish time can only be
    # pessimistic, never silently over-committed. Emulates a deployment
    # where the admission controller sees compressed queue statistics
    # rather than every request's exact token counts.
    stats: str = "exact"
    sketch_width: int = 256       # admission sketch columns (power of two)
    sketch_depth: int = 4         # admission sketch hash rows


class Engine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, *, device=None):
        """``params``: the model (``models.model.init_model`` or
        ``models.convert.params_from_reference``), on ``device`` (default:
        the current CUDA device; without one this raises). An MoE model
        holds its experts over the stacked expert slots it was built with
        (``init_model(ep_slots=)``, where the reference's engine takes a
        mesh). MoE layers run with the default placement, as the
        reference's engine runs them."""
        if cfg.ssm is not None or cfg.xlstm is not None:
            raise ValueError("state-based archs use the decode step directly")
        self.device = default_device(device, "Engine")
        if params.device != self.device:
            raise ValueError(f"the model is on {params.device}, the engine on {self.device}")
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        # Host-clock telemetry of the last run(): seconds of each admission's
        # prefill (ending in the first token's copy to the host) and of each
        # decode step (ending in the next tokens' copy).
        self.prefill_seconds: List[float] = []
        self.step_seconds: List[float] = []
        self.last_balance_ratio = 1.0
        self.last_finish_ratio = 1.0
        # Configured lane speeds are validated AND normalised to mean 1
        # exactly once, here, and the normalised vector is what every
        # plan sees. (Speeds are relative — the schedulers only consume
        # ratios — and the metered path already arrives mean-1; returning
        # the raw configured vector would hand the schedulers a different
        # scale per source. A uniform [2, 2, 2, 2] now plans identically
        # to None, as it should.)
        self._lane_speeds: Optional[np.ndarray] = None
        if ecfg.lane_speeds is not None:
            v = sched_lib.normalize_speeds(ecfg.lane_speeds, ecfg.lanes)
            self._lane_speeds = v / v.mean()
        # Measured decode throughput per lane (tokens/second, EWMA). Only
        # consulted when ecfg.adaptive — on homogeneous hardware the
        # measurements are ≈ equal and admission matches P||C_max anyway.
        self.lane_meter = SlotSpeedEstimator(ecfg.lanes, ewma=ecfg.speed_ewma)
        # Per-job decode metering: one estimator per job id — the rows of
        # the engine's R-matrix. A job's admission and mid-run replans use
        # its OWN row once it has observations; the global meter stays the
        # fallback for unmetered jobs (and the single-job fast path, where
        # the two see the same measurements).
        self.job_meters: Dict[int, SlotSpeedEstimator] = {}
        # Mid-run replan state: the speeds the live queue plan was built
        # under (global + per-job rows), and telemetry for the
        # drift-triggered replans.
        self._planned_speeds: Optional[np.ndarray] = None
        self._planned_job_speeds: Dict[int, np.ndarray] = {}
        self.replans = 0
        self.last_replan_drift: Optional[float] = None
        # Elastic mesh: lanes whose device vanished. A configured lane
        # speed of exact 0.0 seeds the mask (launch/serve --slot-slowdown
        # i:0 in engine mode); ``set_lane_failure`` flips it at runtime.
        # Dead lanes admit nothing, plan to nothing (the Q||C_max
        # schedulers compact onto the alive set at speed 0), and are
        # masked out of the throughput meter so they never re-inherit
        # work from a stale measurement.
        self._dead_lanes = np.zeros(ecfg.lanes, dtype=bool)
        self.mesh_events: List[dict] = []
        # Sketch-planned admission (EngineConfig.stats="sketch"): the
        # count-min hash family the admission loads are estimated
        # through, plus telemetry (#plans that used estimated loads).
        self._admission_sketch: Optional[sp.CountMinParams] = None
        if ecfg.stats not in ("exact", "sketch"):
            raise ValueError(
                f"EngineConfig.stats must be 'exact' or 'sketch', got"
                f" {ecfg.stats!r}")
        if ecfg.stats == "sketch":
            self._admission_sketch = sp.CountMinParams(
                width=ecfg.sketch_width, depth=ecfg.sketch_depth)
        self.sketch_admissions = 0
        if self._lane_speeds is not None and np.any(self._lane_speeds == 0.0):
            for lane in np.flatnonzero(self._lane_speeds == 0.0):
                self.set_lane_failure(int(lane))

    # -- elastic mesh (lane accounting) -------------------------------------

    def set_lane_failure(self, lane: int, dead: bool = True) -> None:
        """Declare one lane dead (device vanished) or revived (join).

        Effective at the next plan: ``lane_speeds`` pins the lane to
        exact 0.0, so admission assigns it nothing, and the meter masks
        it out. With ``replan_on_drift`` the next drift check sees a
        dead-mask change — ``speed_drift`` reports ``inf`` on a mask
        mismatch — and re-plans the waiting queues off the lane
        immediately; running work is never migrated (§7). Emits a mesh
        event to ``EngineConfig.on_mesh_change`` / ``mesh_events``.
        """
        if not 0 <= lane < self.ecfg.lanes:
            raise ValueError(f"lane {lane} out of range [0, {self.ecfg.lanes})")
        if bool(self._dead_lanes[lane]) == bool(dead):
            return
        self._dead_lanes[lane] = dead
        if self._lane_speeds is not None:
            # Configured vectors get the overlay in-place: 0.0 while
            # dead; a revived lane rejoins at nominal speed.
            self._lane_speeds[lane] = 0.0 if dead else 1.0
        self.lane_meter.set_slot_failure(lane, dead=dead)
        for meter in self.job_meters.values():
            meter.set_slot_failure(lane, dead=dead)
        event = {
            "event": "lane_dead" if dead else "lane_join",
            "lane": int(lane),
            "lanes": int(self.ecfg.lanes),
            "alive": int(self.ecfg.lanes - int(self._dead_lanes.sum())),
        }
        self.mesh_events.append(event)
        if self.ecfg.on_mesh_change is not None:
            self.ecfg.on_mesh_change(event)

    @property
    def dead_lanes(self) -> np.ndarray:
        """Boolean mask of vanished lanes (copy)."""
        return self._dead_lanes.copy()

    # -- Q||C_max lane assignment (the §4.2 schedule, speed-aware) ----------

    def lane_speeds(self, job: Optional[int] = None) -> Optional[np.ndarray]:
        """Relative lane speeds admission plans under (None ≡ all nominal).

        Configured ``lane_speeds`` win (returned in their mean-1
        normalised form — normalisation happens once in ``__init__``);
        otherwise the measured decode throughput when ``adaptive`` and at
        least one run was metered. With a ``job`` id, that job's *own*
        metered row wins over the global meter once it has observations —
        the engine's slice of the multi-job R-matrix (different jobs can
        legitimately measure different relative lane speeds). Dead lanes
        read exact 0.0 from every source — and force a concrete vector
        even when neither source is configured, so a plan can never hand
        work to a vanished lane.
        """
        if self._lane_speeds is not None:
            return self._lane_speeds
        speeds = None
        if self.ecfg.adaptive:
            meter = self.job_meters.get(job) if job is not None else None
            if meter is not None and meter.observations > 0:
                speeds = meter.speeds()
            else:
                speeds = self.lane_meter.speeds()
        if np.any(self._dead_lanes):
            if speeds is None:
                speeds = np.ones(self.ecfg.lanes, np.float64)
            return np.where(self._dead_lanes, 0.0, speeds)
        return speeds

    def observe_job_lane_times(self, job: int, lane_tokens, lane_seconds
                               ) -> None:
        """Feed one job's measured per-lane (tokens, seconds) into its row.

        Creates the job's estimator on first use (inheriting the dead-lane
        mask) — the external hook for deployments where per-job decode
        timings arrive from the serving fabric rather than this process's
        own ``run`` loop.
        """
        meter = self.job_meters.get(job)
        if meter is None:
            meter = SlotSpeedEstimator(self.ecfg.lanes,
                                       ewma=self.ecfg.speed_ewma)
            for lane in np.flatnonzero(self._dead_lanes):
                meter.set_slot_failure(int(lane))
            self.job_meters[job] = meter
        meter.update(lane_tokens, lane_seconds)

    def job_weight(self, job: int) -> float:
        """The job's ΣwᵢCᵢ priority weight (default 1.0)."""
        if self.ecfg.job_weights is None:
            return 1.0
        return float(self.ecfg.job_weights.get(job, 1.0))

    def r_matrix(self, jobs: Sequence[int]) -> np.ndarray:
        """Per-(job, lane) processing times for unit work: ``1 / speeds``.

        Rows come from each job's own lane-speed row; a dead lane is
        ``+inf`` in every row. This is the matrix view multi-job
        admission reasons about (and tests inspect).
        """
        rows = []
        for j in jobs:
            row = self.lane_speeds(job=j)
            s = (np.ones(self.ecfg.lanes, np.float64) if row is None
                 else np.asarray(row, np.float64))
            out = np.full(self.ecfg.lanes, np.inf)
            out[s > 0.0] = 1.0 / s[s > 0.0]
            rows.append(out)
        return np.stack(rows) if rows else np.zeros((0, self.ecfg.lanes))

    def _admission_loads(self, requests: List[Request]) -> np.ndarray:
        """Per-request loads as admission sees them (exact or estimated).

        ``EngineConfig.stats == "sketch"``: the waiting queue's (rid,
        load) pairs are folded into a count-min sketch and each load is
        read back as an estimate — overestimate-only (count-min reads are
        ``true + non-negative collision mass``), so lane finish budgets
        are pessimistic but never over-committed. Exact mode returns the
        true loads unchanged (bit-pinned by the serving tests).
        """
        loads = np.asarray([r.load for r in requests], np.float64)
        cm = self._admission_sketch
        if cm is None or not requests:
            return loads
        counters = np.zeros((cm.depth, cm.width))
        rids = np.asarray([r.rid for r in requests], np.int64)
        cm.add_dense(counters, rids, loads)
        self.sketch_admissions += 1
        return cm.estimate(counters, rids)

    def plan(self, requests: List[Request]) -> Dict[int, List[Request]]:
        """Admit requests onto lanes: Q||C_max per job, R||C_max across jobs.

        Single-job traffic takes the original path unchanged (bit-pinned
        by the serving tests). With several job ids present, job groups
        are ordered by weighted completion time (Smith's rule on weight /
        total load) and placed group-by-group with earliest-finish-time
        onto the *cumulative* lane finish times, each group under its own
        lane-speed row — an R||C_max EFT where the row really can differ
        per job. ``max_concurrent_jobs`` caps how many jobs interleave:
        groups beyond the cap queue strictly behind the earlier wave.
        Under ``stats="sketch"`` both paths budget lanes from count-min
        load estimates (:meth:`_admission_loads`) instead of exact loads.
        """
        speeds = self.lane_speeds()
        self._planned_speeds = (np.ones(self.ecfg.lanes) if speeds is None
                                else np.asarray(speeds, np.float64))
        self._planned_job_speeds = {}
        job_ids = list(dict.fromkeys(r.job for r in requests))
        if len(job_ids) > 1:
            return self._plan_multi_job(requests, job_ids)
        loads = self._admission_loads(requests)
        if job_ids:
            row = self.lane_speeds(job=job_ids[0])
            if row is not None:
                speeds = row
                self._planned_job_speeds[job_ids[0]] = \
                    np.asarray(row, np.float64).copy()
        if self.ecfg.scheduler == "hash":
            sched = sched_lib.schedule_hash(
                loads, self.ecfg.lanes,
                keys=np.asarray([r.rid for r in requests]), speeds=speeds)
        elif self.ecfg.scheduler == "lpt":
            sched = sched_lib.schedule_lpt(loads, self.ecfg.lanes,
                                           speeds=speeds)
        else:
            sched = sched_lib.schedule_bss(loads, self.ecfg.lanes,
                                           speeds=speeds)
        by_lane: Dict[int, List[Request]] = {
            i: [] for i in range(self.ecfg.lanes)}
        for r, lane in zip(requests, sched.assignment):
            r.lane = int(lane)
            by_lane[int(lane)].append(r)
        for lane in by_lane:  # §4.4 order: increasing load first
            by_lane[lane].sort(key=lambda r: r.load)
        self.last_balance_ratio = sched.balance_ratio
        self.last_finish_ratio = sched.finish_ratio
        return by_lane

    def _plan_multi_job(
        self, requests: List[Request], job_ids: List[int]
    ) -> Dict[int, List[Request]]:
        """The R||C_max admission path (≥ 2 jobs present)."""
        groups: Dict[int, List[Request]] = {j: [] for j in job_ids}
        est_load = dict(zip(
            (id(r) for r in requests), self._admission_loads(requests)))
        for r in requests:
            groups[r.job].append(r)
        totals = np.asarray(
            [sum(est_load[id(r)] for r in groups[j]) for j in job_ids])
        weights = np.asarray([self.job_weight(j) for j in job_ids])
        admit = [job_ids[i] for i in sim.wspt_order(totals, weights)]
        cap = self.ecfg.max_concurrent_jobs or len(admit)
        cap = max(int(cap), 1)
        lanes = self.ecfg.lanes
        lane_finish = np.zeros(lanes)
        lane_loads = np.zeros(lanes)
        by_lane: Dict[int, List[Request]] = {i: [] for i in range(lanes)}
        admit_pos = {j: k for k, j in enumerate(admit)}
        for j in admit:
            row = self.lane_speeds(job=j)
            s = (np.ones(lanes, np.float64) if row is None
                 else np.asarray(row, np.float64))
            self._planned_job_speeds[j] = s.copy()
            alive = s > 0.0
            if not np.any(alive):
                raise RuntimeError("all lanes dead: cannot admit requests")
            for r in sorted(groups[j], key=lambda r: -est_load[id(r)]):
                with np.errstate(divide="ignore"):
                    cand = np.where(
                        alive,
                        lane_finish + est_load[id(r)] / np.where(alive, s, 1.0),
                        np.inf)
                lane = int(np.argmin(cand))
                r.lane = lane
                by_lane[lane].append(r)
                lane_finish[lane] = cand[lane]
                lane_loads[lane] += est_load[id(r)]
        for lane in by_lane:
            # Earlier-admitted jobs keep queue priority; within a job the
            # §4.4 increasing-load order stands (sort is stable).
            by_lane[lane].sort(key=lambda r: (admit_pos[r.job], r.load))
        alive_mask = lane_finish[np.isfinite(lane_finish)]
        ideal_load = lane_loads.sum() / max(lanes, 1)
        self.last_balance_ratio = (
            float(lane_loads.max() / ideal_load) if ideal_load > 0 else 1.0)
        mean_finish = alive_mask.mean() if alive_mask.size else 0.0
        self.last_finish_ratio = (
            float(lane_finish.max() / mean_finish) if mean_finish > 0
            else 1.0)
        return by_lane

    def maybe_replan_waiting(self, queues: Dict[int, List[Request]]) -> bool:
        """Re-plan the waiting queues if measured lane speeds drifted.

        The OS4M straggler response applied mid-serve: compare the
        current measured lane speeds against the speeds the live plan was
        built under (:func:`repro_torch.core.slot_speeds.speed_drift`); past
        ``max_speed_drift``, pool every request still WAITING and run a
        fresh global plan under the fresh speeds, mutating ``queues`` in
        place. Every job with waiting requests is checked against **its
        own row** of the R-matrix (the speeds its part of the plan was
        actually built under) — a job whose slow lane sped up must
        replan even while the global average moved nowhere, and vice
        versa. Running requests are never migrated (their KV cache stays
        put). Returns True when a replan happened; telemetry in
        ``self.replans`` / ``self.last_replan_drift``.
        """
        fresh = self.lane_speeds()
        drift: Optional[float] = None
        if fresh is not None and self._planned_speeds is not None:
            drift = speed_drift(self._planned_speeds, fresh)
        waiting = [r for q in queues.values() for r in q]
        for j in sorted({r.job for r in waiting}):
            ref_j = self._planned_job_speeds.get(j)
            fresh_j = self.lane_speeds(job=j)
            if ref_j is not None and fresh_j is not None:
                d = speed_drift(ref_j, fresh_j)
                drift = d if drift is None else max(drift, d)
        if drift is None:   # nothing measured against nothing planned
            return False
        self.last_replan_drift = drift
        if drift <= self.ecfg.max_speed_drift:
            return False
        if not waiting:
            return False
        replanned = self.plan(waiting)   # also re-anchors the planned rows
        for lane in queues:
            queues[lane] = replanned.get(lane, [])
        self.replans += 1
        return True

    # -- steps ----------------------------------------------------------------

    def _decode(self, params, cache, tokens, pos_vec):
        """One lock-step decode of every lane: (cache, next tokens (B,))."""
        out = forward(params, self.cfg, tokens=tokens, mode="decode", cache=cache,
                      cache_pos=pos_vec)
        nxt = torch.argmax(out.logits[:, -1], dim=-1).to(torch.int32)
        return out.cache, nxt

    @staticmethod
    def _merge_lane(cache, new_cache, lane: int):
        """Splice one lane's rows (batch axis 1) from new_cache into cache,
        in place (dicts and tuples walked, as the reference's tree map);
        returns cache."""
        if isinstance(cache, dict):
            for key in cache:
                Engine._merge_lane(cache[key], new_cache[key], lane)
        elif isinstance(cache, tuple):
            for old, new in zip(cache, new_cache, strict=True):
                Engine._merge_lane(old, new, lane)
        else:
            cache[:, lane] = new_cache[:, lane]
        return cache

    # -- serving -------------------------------------------------------------

    def run(self, requests: List[Request], extra_embed=None) -> List[Request]:
        """Serve ``requests``; ``extra_embed`` (a tensor or numpy array of
        ``(lanes, P, d)``: a vlm config's patches, whisper's frames) goes
        to every prefill."""
        with torch.inference_mode():
            return self._run(requests, extra_embed)

    def _run(self, requests: List[Request], extra_embed) -> List[Request]:
        ecfg = self.ecfg
        dev = self.device
        if extra_embed is not None:
            extra_embed = torch.as_tensor(extra_embed, device=dev)
        queues = self.plan(requests)
        cache = init_cache(self.cfg, ecfg.lanes, ecfg.max_len, dtype=torch.float32,
                           device=dev)
        pos = np.zeros(ecfg.lanes, dtype=np.int64)
        budget = np.zeros(ecfg.lanes, dtype=np.int64)
        cur = np.zeros(ecfg.lanes, dtype=np.int32)
        active: Dict[int, Request] = {}
        done: List[Request] = []
        self.prefill_seconds = []
        self.step_seconds = []

        def admit(lane: int, cache):
            """Prefill the lane's next request; returns the updated cache."""
            # Belt-and-braces: the planner already routes nothing to a
            # lane with speed 0.0, but a lane that died *after* planning
            # must neither prefill nor strand its queue — hand the
            # waiting requests to the shortest surviving queue.
            if self._dead_lanes[lane]:
                if queues[lane]:
                    alive = np.flatnonzero(~self._dead_lanes)
                    if alive.size == 0:
                        raise RuntimeError(
                            "all lanes dead with requests still queued")
                    dest = int(min(alive, key=lambda a: len(queues[a])))
                    queues[dest].extend(queues[lane])
                    queues[lane].clear()
                return cache
            if not queues[lane]:
                return cache
            t0 = time.perf_counter()
            r = queues[lane].pop(0)
            r.output = []
            p = r.prompt.shape[0]
            toks = torch.as_tensor(np.asarray(r.prompt, np.int32)[None, :],
                                   device=dev).expand(ecfg.lanes, p)
            out = forward(self.params, self.cfg, tokens=toks, extra_embed=extra_embed,
                          mode="prefill", cache=cache)
            cache = self._merge_lane(cache, out.cache, lane)
            first = int(torch.argmax(out.logits[0, -1]))
            del out
            active[lane] = r
            pos[lane] = p
            budget[lane] = r.max_new - 1
            cur[lane] = first
            r.output.append(first)
            self.prefill_seconds.append(time.perf_counter() - t0)
            return cache

        for lane in range(ecfg.lanes):
            cache = admit(lane, cache)

        # Per-lane decode throughput metering: tokens produced and wall
        # time while the lane was active. Feeds the next plan's lane
        # speeds when ecfg.adaptive. Two caveats: the first decode step
        # carries one-time set-up (the reference's jit compile; here the
        # first launches) and is excluded; and on a single-device
        # lock-step batch every active lane shares one step clock, so
        # measured rates only separate lanes when decode actually runs
        # per-device — the meter then reads ≈uniform and admission
        # matches P||C_max, while `lane_speeds` injection stays the
        # deterministic way to model a slow lane.
        lane_tokens = np.zeros(ecfg.lanes)
        lane_seconds = np.zeros(ecfg.lanes)
        # The same measurements split per job id: each job's share of the
        # decode clock builds that job's row of the R-matrix.
        job_tokens: Dict[int, np.ndarray] = {}
        job_seconds: Dict[int, np.ndarray] = {}

        def flush_meter():
            """Fold the accumulated per-lane (tokens, seconds) into the meter."""
            if lane_tokens.any():
                self.lane_meter.update(lane_tokens, lane_seconds)
                lane_tokens[:] = 0.0
                lane_seconds[:] = 0.0
            for j, toks_j in job_tokens.items():
                if toks_j.any():
                    self.observe_job_lane_times(j, toks_j, job_seconds[j])
                    toks_j[:] = 0.0
                    job_seconds[j][:] = 0.0

        step = 0
        while active:
            t0 = time.perf_counter()
            toks = torch.as_tensor(cur[:, None], device=dev)
            cache, nxt = self._decode(self.params, cache, toks,
                                      torch.as_tensor(pos, device=dev))
            nxt = nxt.cpu().numpy()
            elapsed = time.perf_counter() - t0
            self.step_seconds.append(elapsed)
            dt = elapsed if step > 0 else 0.0
            step += 1
            for lane, r in list(active.items()):
                token = int(nxt[lane])
                if dt > 0.0:
                    lane_tokens[lane] += 1
                    lane_seconds[lane] += dt
                    if r.job not in job_tokens:
                        job_tokens[r.job] = np.zeros(ecfg.lanes)
                        job_seconds[r.job] = np.zeros(ecfg.lanes)
                    job_tokens[r.job][lane] += 1
                    job_seconds[r.job][lane] += dt
                r.output.append(token)
                pos[lane] += 1
                budget[lane] -= 1
                cur[lane] = token
                if token == ecfg.eos or budget[lane] <= 0 \
                        or pos[lane] >= ecfg.max_len - 1:
                    done.append(r)
                    del active[lane]
                    cache = admit(lane, cache)
            # Mid-run replan: periodically fold the live measurements into
            # the meter and re-plan the waiting queues if a lane's measured
            # speed drifted past the threshold — instead of only reacting
            # at the next run() boundary.
            if (ecfg.replan_on_drift and ecfg.adaptive
                    and step % max(ecfg.replan_check_every, 1) == 0):
                flush_meter()
                self.maybe_replan_waiting(queues)
        flush_meter()
        return done
