"""Steady-state schedule reuse with drift detection.

OS4M's schedule is a function of the measured key distribution, and key
distributions are stable across batches of one workload. This module
decouples *planning* from *execution*: a :class:`CachedSchedule`
snapshots everything the host produced for one plan — the Q||C_max
assignment (with the per-slot speeds it was built for), the §4.4 wave
plan, the statistics-sized send capacities, and the per-shard ``K^(i)``
histograms (or count-min cells) the plan was derived from — and a
:class:`ReusePolicy` decides per batch whether to replay that snapshot or
replan from fresh statistics. Replans trigger on *key* drift (the
distribution moved) or *speed* drift (a slot slowed past
``max_speed_drift`` — see :mod:`repro_torch.core.slot_speeds`).

The decision is cheap by construction: the drift metric is a torch
reduction on the statistics' own device against a baseline uploaded once
(:meth:`CachedSchedule.hist_device`); only the scalar crosses to the
host. A reused batch therefore never pulls the full ``(m, S)``
statistics and never runs a scheduler.

Correctness backstop: a reused schedule's send capacities were sized from
*plan-time* statistics, so a sub-threshold drift could still overflow a
buffer. Phase B counts overflowed pairs exactly; the job treats a nonzero
count on a reused run as a forced replan + re-execution
(``capacity_fallbacks`` in :meth:`ScheduleCache.stats`), so outputs are
always exact. :class:`ReusePolicy.capacity_slack` sizes the headroom that
makes this rare.

The JSON form of :class:`CachedSchedule` is the reference's, so a
snapshot written by ``repro`` loads here and the reverse. On an elastic
resize a snapshot is re-projected onto the new slot count
(:func:`rebin_hist`, :meth:`CachedSchedule.reproject`) instead of going
cold; :class:`MultiTenantScheduleCache` keys one isolated cache per job
of a multi-job coordinator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import pipeline as pipe
from repro_torch.core import scheduler as sched_lib
from repro_torch.core import slot_speeds as ss

__all__ = [
    "DRIFT_METRICS",
    "drift_metric",
    "rebin_hist",
    "ReusePolicy",
    "ReuseDecision",
    "CachedSchedule",
    "ScheduleCache",
    "MultiTenantScheduleCache",
]

DRIFT_METRICS = ("l1", "chi2")


def drift_metric(ref_hist, new_hist, kind: str = "l1") -> torch.Tensor:
    """Distance in ``[0, 1]`` between two key histograms, as a 0-d tensor.

    Both inputs are ``(n,)`` or ``(m, n)`` count arrays (``K`` or the
    per-shard ``K^(i)``), tensors or numpy arrays; 2-D inputs score each
    shard's distribution separately and return the **max over shards** —
    the per-shard view is what the statistics-sized send capacities depend
    on. The reduction runs in float32 on ``new_hist``'s device (the CPU
    for numpy input); the caller pulls the scalar.

    ``kind="l1"``   — total variation: ``0.5 * sum |p - q|``.
    ``kind="chi2"`` — symmetric chi-square: ``0.5 * sum (p-q)^2 / (p+q)``.

    Rows are normalised to distributions first, so the metric sees shape
    change only — batch-size change alone is zero drift.
    """
    if kind not in DRIFT_METRICS:
        raise ValueError(f"unknown drift metric {kind!r}; use one of {DRIFT_METRICS}")
    dev = new_hist.device if isinstance(new_hist, torch.Tensor) else torch.device("cpu")
    p = torch.as_tensor(ref_hist, dtype=torch.float32, device=dev)
    q = torch.as_tensor(new_hist, dtype=torch.float32, device=dev)
    if p.dim() == 1:
        p = p[None, :]
    if q.dim() == 1:
        q = q[None, :]
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    q = q / q.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    if kind == "l1":
        per_shard = 0.5 * (p - q).abs().sum(dim=-1)
    else:
        per_shard = 0.5 * ((p - q) ** 2 / (p + q).clamp_min(1e-9)).sum(dim=-1)
    return per_shard.max()


def rebin_hist(local_hist, new_m: int) -> np.ndarray:
    """Re-bin per-shard histograms ``(m, n) → (new_m, n)``, conserving mass.

    The elastic-mesh statistics re-projection: shard axes are treated as
    equal-width intervals of the same unit range (old shard ``i`` covers
    ``[i/m, (i+1)/m)``, new shard ``j`` covers ``[j/new_m, (j+1)/new_m)``)
    and each old row's counts are split across the new rows by fractional
    interval overlap. Per-cluster totals (the column sums — the global
    ``K`` the schedule is actually planned from) are preserved exactly up
    to float rounding, so a resized mesh replans from *warm* statistics
    instead of paying a cold measurement pass.

    Overlaps are computed on the common integer scale ``m * new_m`` so the
    weights are exact rationals (``overlap / new_m``), not accumulated
    float boundaries.
    """
    h = np.asarray(local_hist, np.float64)
    if h.ndim != 2:
        raise ValueError(f"local_hist must be (m, n), got {h.shape}")
    m = h.shape[0]
    if new_m < 1:
        raise ValueError("new_m must be >= 1")
    if new_m == m:
        return h.copy()
    out = np.zeros((new_m, h.shape[1]))
    for i in range(m):
        a, b = i * new_m, (i + 1) * new_m   # old row i on the common scale
        for j in range(a // m, -(-b // m)):
            c, d = j * m, (j + 1) * m       # new row j on the common scale
            ov = min(b, d) - max(a, c)
            if ov > 0:
                out[j] += h[i] * (ov / new_m)
    return out


@dataclasses.dataclass(frozen=True)
class ReusePolicy:
    """When may a cached schedule be replayed instead of replanned?

    ``max_drift``        — replan when the measured drift (``metric``)
                           between the plan-time and fresh ``K^(i)``
                           exceeds this threshold.
    ``max_age``          — replan after this many batches regardless of
                           drift (``None`` = never force; age counts
                           batches *executed with* the cached plan).
    ``revalidate_every`` — compute the drift metric only every k-th batch;
                           in between, reuse unconditionally. 1 = check
                           every batch.
    ``metric``           — ``"l1"`` (total variation) or ``"chi2"``.
    ``capacity_slack``   — fractional headroom added to the plan's send
                           capacities so sub-threshold drift rarely
                           overflows (overflow forces a replan + re-run).
    ``max_speed_drift``  — replan when any slot's measured relative speed
                           moved more than this fraction from the speeds
                           the plan was built for (see
                           :func:`repro_torch.core.slot_speeds.speed_drift`).
    ``cost_gate``        — with ``scheduler="auto"``: when drift trips,
                           first ask :func:`repro_torch.core.simulator.
                           estimate_replan_benefit` whether a fresh plan
                           actually beats the stale schedule's expected
                           imbalance; if not, keep reusing (the drift
                           baseline is refreshed so the question is not
                           re-asked every batch).
    """

    max_drift: float = 0.15
    max_age: Optional[int] = None
    revalidate_every: int = 1
    metric: str = "l1"
    capacity_slack: float = 0.25
    max_speed_drift: float = 0.25
    cost_gate: bool = False

    def __post_init__(self):
        """Validate thresholds at construction (fail loud, not per batch)."""
        if self.max_drift < 0:
            raise ValueError("max_drift must be >= 0")
        if self.max_age is not None and self.max_age < 1:
            raise ValueError("max_age must be >= 1 (or None)")
        if self.revalidate_every < 1:
            raise ValueError("revalidate_every must be >= 1")
        if self.metric not in DRIFT_METRICS:
            raise ValueError(f"metric must be one of {DRIFT_METRICS}")
        if self.capacity_slack < 0:
            raise ValueError("capacity_slack must be >= 0")
        if self.max_speed_drift < 0:
            raise ValueError("max_speed_drift must be >= 0")


@dataclasses.dataclass(frozen=True)
class ReuseDecision:
    """One per-batch reuse-or-replan verdict (``JobResult.plan_reason`` echoes it).

    ``action`` is ``"reuse"`` or ``"replan"``; ``reason`` one of ``cold``
    (no snapshot yet), ``ok`` (drift under threshold), ``unchecked``
    (between revalidations), ``drift``, ``speed_drift`` (a slot's measured
    speed moved past ``max_speed_drift``), ``slot_dead`` (the set of
    exact-0.0 speeds changed between plan time and now), ``max_age``,
    ``cost_gate`` (drift tripped but the simulator found replanning not
    worth it), ``overflow`` (a reused run overflowed its capacities and
    was re-run). ``drift`` is the measured key-distribution metric and
    ``speed_drift`` the measured slot-speed change, when they were
    computed this batch.
    """

    action: str
    reason: str
    drift: Optional[float] = None
    speed_drift: Optional[float] = None


@dataclasses.dataclass
class CachedSchedule:
    """Everything phase B needs to replay one plan, plus its provenance.

    ``schedule`` + ``waves`` + the capacities fully determine phase B's
    shapes, and ``local_hist`` is the per-shard statistics the plan was
    derived from — the drift reference. ``key_dist`` is its shard-sum
    for exact statistics. Sketch snapshots store the raw counter cells in
    ``local_hist`` (shape ``(m, depth * width)``), which keeps the drift
    metric working unchanged, and carry ``key_dist`` explicitly in JSON
    (it is an estimate, not a column sum of the cells). :meth:`to_json` /
    :meth:`from_json` are a lossless pair and share the reference's
    layout.
    """

    schedule: sched_lib.Schedule
    strategy: str
    strategy_costs: Optional[Dict[str, float]]
    waves: pipe.WavePlan
    capacity: int                    # sequential-path per-(shard,dest) cap
    chunk_caps: Tuple[int, ...]      # per-wave caps (pipelined path)
    local_hist: np.ndarray           # (m, n) plan-time K^(i) (or sketch cells)
    key_dist: np.ndarray             # (n,)  plan-time K (exact or estimated)
    age: int = 0                     # batches executed with this plan
    batches_since_check: int = 0
    k_per_shard: Optional[int] = None  # plan-time pairs per shard
    stats_provider: str = "exact"    # which provider produced local_hist
    stats_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # True when every capacity in this plan came from overestimate-only
    # statistics (exact counts or a pure count-min read with intact f32
    # guard) — such caps can never under-provision. False only for
    # estimate-committed caps (prefix-planned wave 1), which instead arm
    # the overflow escape hatch below.
    stats_overestimate: bool = True
    # True when a chunk capacity was committed from a prefix estimate and
    # may under-provision; the runner's overflow escape hatch
    # (``MapReduceJob._escalate_caps``) watches this flag.
    caps_estimated: bool = False
    _hist_dev: Any = dataclasses.field(default=None, repr=False)

    @property
    def slot_speeds(self) -> np.ndarray:
        """The per-slot relative speeds this plan was built for (Q||C_max)."""
        return self.schedule.slot_speeds

    def hist_device(self, device=None, put=None):
        """The plan-time statistics as a float32 tensor on ``device``.

        Uploaded at the first call and kept: every later drift check on
        the same device reads the resident baseline and uploads nothing.
        ``put`` (instead of ``device``) places the one upload itself and
        returns what it placed: the sharded backend puts row ``j`` on slot
        ``j``'s device.
        """
        if put is not None:
            if self._hist_dev is None:
                self._hist_dev = put(np.asarray(self.local_hist, np.float32))
            return self._hist_dev
        device = torch.device(device)
        if self._hist_dev is None or self._hist_dev.device != device:
            h = np.asarray(self.local_hist, np.float32)
            self._hist_dev = torch.as_tensor(h, device=device)
        return self._hist_dev

    def refresh_baseline(self, local_hist: np.ndarray,
                         key_dist: Optional[np.ndarray] = None) -> None:
        """Re-anchor the drift reference without replanning (cost-gated reuse).

        ``key_dist`` must be supplied when ``local_hist`` is provider
        state whose global distribution is not its column sum (sketch
        cells); exact callers can omit it.
        """
        self.local_hist = np.asarray(local_hist)
        self.key_dist = (self.local_hist.sum(axis=0) if key_dist is None
                         else np.asarray(key_dist))
        self._hist_dev = None

    def reproject(self, new_num_slots: int, planner) -> "CachedSchedule":
        """Re-project this snapshot onto a different slot count (elastic mesh).

        Instead of discarding warm state on a resize, the per-shard
        ``K^(i)`` baseline is re-binned onto the new shard count
        (:func:`rebin_hist` — per-cluster mass preserved) and ``planner``
        — the job's ``_plan``-shaped callable
        ``planner(local_hist, key_dist, k_per_shard, prev)`` — is invoked
        once on the re-binned statistics to rebuild assignment, wave plan
        and capacities for the new mesh. The result is a fully executable
        snapshot whose drift baseline is the re-binned history, so the
        next batch's decide() compares against warm statistics (and
        reuses, when the workload is stationary) rather than starting
        cold. ``k_per_shard`` is re-scaled so total plan-time pairs are
        conserved (``ceil(k · m / new_m)``).
        """
        if new_num_slots < 1:
            raise ValueError("new_num_slots must be >= 1")
        old_m = int(self.local_hist.shape[0])
        if new_num_slots == old_m:
            return self
        new_hist = rebin_hist(self.local_hist, new_num_slots)
        k = self.k_per_shard
        if k is None:  # pre-elastic snapshot: bound from the statistics
            k = int(np.ceil(self.local_hist.sum(axis=1).max()))
        new_k = int(np.ceil(k * old_m / new_num_slots))
        snap = planner(new_hist, new_hist.sum(axis=0), new_k, None)
        snap.k_per_shard = new_k
        return snap

    def to_json(self) -> Dict[str, Any]:
        """Serialize plan + provenance (not the device mirror) to plain types.

        Sketch snapshots additionally serialize ``key_dist`` — for exact
        snapshots it is recomputed from ``local_hist`` on load, but a
        sketch's global distribution is an estimate, not a column sum of
        its counter cells.
        """
        out = {
            "assignment": self.schedule.assignment.tolist(),
            "num_slots": int(self.schedule.num_slots),
            "slot_speeds": [float(s) for s in self.schedule.slot_speeds],
            "strategy": self.strategy,
            "waves": self.waves.to_json(),
            "capacity": int(self.capacity),
            "chunk_caps": [int(c) for c in self.chunk_caps],
            "local_hist": self.local_hist.tolist(),
            "age": int(self.age),
            "k_per_shard": None if self.k_per_shard is None
            else int(self.k_per_shard),
            "stats": {
                "provider": self.stats_provider,
                "params": dict(self.stats_params),
                "overestimate": bool(self.stats_overestimate),
                "caps_estimated": bool(self.caps_estimated),
            },
        }
        if self.stats_provider != "exact":
            out["key_dist"] = [float(v) for v in np.asarray(self.key_dist)]
        return out

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "CachedSchedule":
        """Rebuild a snapshot from :meth:`to_json` output (either package's)."""
        local_hist = np.asarray(d["local_hist"], np.float64)
        stats = d.get("stats", {})
        provider = stats.get("provider", "exact")
        if "key_dist" in d:
            key_dist = np.asarray(d["key_dist"], np.float64)
        else:
            key_dist = local_hist.sum(axis=0)
        schedule = sched_lib.Schedule.from_assignment(
            np.asarray(d["assignment"], np.int32), key_dist, int(d["num_slots"]),
            speeds=d.get("slot_speeds"),
        )
        return CachedSchedule(
            schedule=schedule,
            strategy=d["strategy"],
            strategy_costs=None,
            waves=pipe.WavePlan.from_json(d["waves"]),
            capacity=int(d["capacity"]),
            chunk_caps=tuple(int(c) for c in d["chunk_caps"]),
            local_hist=local_hist,
            key_dist=key_dist,
            age=int(d.get("age", 0)),
            k_per_shard=(None if d.get("k_per_shard") is None
                         else int(d["k_per_shard"])),
            stats_provider=provider,
            stats_params=dict(stats.get("params", {})),
            stats_overestimate=bool(stats.get("overestimate", True)),
            caps_estimated=bool(stats.get("caps_estimated", False)),
        )


class ScheduleCache:
    """Per-job reuse state: the live snapshot, the policy, and telemetry.

    Drift is computed on the fresh statistics' device: the baseline is
    uploaded there once (:meth:`CachedSchedule.hist_device`) and
    :func:`drift_metric` runs beside it, so only the scalar is pulled.

    ``drift_fn`` (optional) replaces that computation: called as
    ``drift_fn(snapshot, fresh_hist)``, it returns the scalar metric. The
    sharded backend installs one that keeps each slot's baseline row on
    the slot's device and reduces next to its statistics
    (:meth:`repro_torch.core.mapreduce.MapReduceJob._make_sharded_drift`).
    """

    def __init__(self, policy: ReusePolicy, drift_fn=None):
        self.policy = policy
        self.drift_fn = drift_fn
        self.snapshot: Optional[CachedSchedule] = None
        self.replans = 0
        self.reuses = 0
        self.drift_checks = 0
        self.capacity_fallbacks = 0
        self.speed_replans = 0
        self.dead_replans = 0
        self.reprojections = 0
        self.last_drift: Optional[float] = None
        self.last_speed_drift: Optional[float] = None
        self.last_decision: Optional[ReuseDecision] = None

    def decide(self, fresh_local_hist, fresh_speeds=None) -> ReuseDecision:
        """Reuse-or-replan for one batch, given phase A's fresh ``K^(i)``.

        ``fresh_local_hist`` may be a device tensor — the drift reduction
        then runs on that device and only the scalar is pulled.
        ``fresh_speeds`` is the current per-slot speed estimate; a slot
        whose measured speed moved more than ``max_speed_drift`` from the
        plan-time speeds forces a replan even when the key distribution is
        stationary. ``fresh_speeds=None`` means *no measurement*: against a
        plan built for nominal speeds that is no evidence of change (drift
        0), but against a plan built for measured, non-nominal speeds it is
        conservative (``inf``, a replan). Check order: cold → max_age →
        revalidation cadence → dead-slot mask → speed drift → key drift.

        Dead slots are checked *structurally* before any ratio math: when
        the set of exact-0.0 speeds differs between the plan and
        ``fresh_speeds``, the verdict is a forced replan with reason
        ``"slot_dead"``.
        """
        p, s = self.policy, self.snapshot
        if s is None:
            return ReuseDecision("replan", "cold")
        if p.max_age is not None and s.age >= p.max_age:
            return ReuseDecision("replan", "max_age")
        if p.revalidate_every > 1 and s.batches_since_check + 1 < p.revalidate_every:
            s.batches_since_check += 1
            return ReuseDecision("reuse", "unchecked")
        s.batches_since_check = 0
        if fresh_speeds is not None:
            fresh_arr = np.asarray(fresh_speeds, np.float64)
            ref_dead = np.asarray(s.slot_speeds, np.float64) == 0.0
            if (fresh_arr.shape == ref_dead.shape
                    and np.any((fresh_arr == 0.0) != ref_dead)):
                self.dead_replans += 1
                return ReuseDecision("replan", "slot_dead")
        sd = ss.speed_drift(s.slot_speeds, fresh_speeds)
        self.last_speed_drift = sd
        if sd > p.max_speed_drift:
            self.speed_replans += 1
            return ReuseDecision("replan", "speed_drift", speed_drift=sd)
        if self.drift_fn is not None:
            d = float(self.drift_fn(s, fresh_local_hist))
        else:
            dev = (fresh_local_hist.device if isinstance(fresh_local_hist, torch.Tensor)
                   else "cpu")
            d = float(drift_metric(s.hist_device(dev), fresh_local_hist, p.metric))
        self.drift_checks += 1
        self.last_drift = d
        if d > p.max_drift:
            return ReuseDecision("replan", "drift", d, speed_drift=sd)
        return ReuseDecision("reuse", "ok", d, speed_drift=sd)

    def record(self, decision: ReuseDecision) -> None:
        """Count the decision and age the snapshot on reuse."""
        self.last_decision = decision
        if decision.action == "reuse":
            self.reuses += 1
            if self.snapshot is not None:
                self.snapshot.age += 1
        else:
            self.replans += 1

    def store(self, snapshot: CachedSchedule) -> None:
        """Install a freshly planned snapshot (age and cadence reset)."""
        snapshot.age = 0
        snapshot.batches_since_check = 0
        self.snapshot = snapshot

    def stats(self) -> Dict[str, Any]:
        """Telemetry counters (replan rate is ``replans / batches``)."""
        batches = self.replans + self.reuses
        return {
            "batches": batches,
            "replans": self.replans,
            "reuses": self.reuses,
            "drift_checks": self.drift_checks,
            "capacity_fallbacks": self.capacity_fallbacks,
            "speed_replans": self.speed_replans,
            "dead_replans": self.dead_replans,
            "reprojections": self.reprojections,
            "replan_rate": self.replans / batches if batches else 0.0,
            "last_drift": self.last_drift,
            "last_speed_drift": self.last_speed_drift,
        }


class MultiTenantScheduleCache:
    """Per-job keyed :class:`ScheduleCache` snapshots — one cache, N tenants.

    The multi-job coordinator gives each live job its own isolated
    :class:`ScheduleCache` under a string key; snapshots, drift baselines
    and telemetry never cross tenants (job A's plan is useless for job B's
    key distribution, and silently replaying it would be a correctness
    bug, not an optimisation). Isolation is by construction — every
    tenant holds distinct objects — and :meth:`collisions` *measures* it,
    so a test can assert zero rather than trust the construction.
    """

    def __init__(self, policy: Optional[ReusePolicy] = None):
        self.default_policy = policy
        self._tenants: Dict[str, ScheduleCache] = {}

    def tenant(
        self,
        key: str,
        policy: Optional[ReusePolicy] = None,
        drift_fn=None,
    ) -> ScheduleCache:
        """The tenant's cache, created on first use (then args must agree).

        A second caller reaching for an existing key with a *different*
        policy object is almost certainly two jobs colliding on one key;
        that raises instead of silently sharing state.
        """
        cache = self._tenants.get(key)
        if cache is None:
            pol = policy if policy is not None else self.default_policy
            if pol is None:
                raise ValueError(
                    f"tenant {key!r}: no policy given and no default_policy")
            cache = ScheduleCache(pol, drift_fn=drift_fn)
            self._tenants[key] = cache
            return cache
        if policy is not None and cache.policy is not policy:
            raise ValueError(
                f"tenant key collision: {key!r} already exists with a "
                "different ReusePolicy — two jobs must not share one key")
        if drift_fn is not None:
            cache.drift_fn = drift_fn
        return cache

    def adopt(self, key: str, cache: ScheduleCache) -> ScheduleCache:
        """Register an existing per-job cache under a tenant key.

        Used when a job arrives already owning its ScheduleCache (built
        from ``MapReduceConfig.reuse``): the coordinator keys it rather
        than replacing it, so warm snapshots survive admission. Adopting
        a *different* cache under a live key is a collision and raises.
        """
        existing = self._tenants.get(key)
        if existing is not None and existing is not cache:
            raise ValueError(
                f"tenant key collision: {key!r} already holds another cache")
        self._tenants[key] = cache
        return cache

    def keys(self):
        """Tenant keys currently live (insertion order)."""
        return list(self._tenants)

    def collisions(self) -> int:
        """Snapshot objects shared between two tenants (must be 0).

        Counts pairs of distinct tenants whose live ``snapshot`` (or the
        snapshot's device-resident baseline histogram) is the *same
        object* — the observable form of a cross-job cache collision.
        """
        shared = 0
        items = list(self._tenants.values())
        for a in range(len(items)):
            for b in range(a + 1, len(items)):
                sa, sb = items[a].snapshot, items[b].snapshot
                if sa is None or sb is None:
                    continue
                if sa is sb or (sa._hist_dev is not None
                                and sa._hist_dev is sb._hist_dev):
                    shared += 1
        return shared

    def stats(self) -> Dict[str, Any]:
        """Aggregate + per-tenant telemetry (collision count included)."""
        per = {k: c.stats() for k, c in self._tenants.items()}
        agg = {
            "tenants": len(per),
            "collisions": self.collisions(),
            "batches": sum(s["batches"] for s in per.values()),
            "replans": sum(s["replans"] for s in per.values()),
            "reuses": sum(s["reuses"] for s in per.values()),
        }
        agg["per_tenant"] = per
        return agg
