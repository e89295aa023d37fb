"""Multi-job coordination: N MapReduce workloads sharing one mesh.

OS4M (§3.2, §4.2) plans one job's Reduce operations globally; production
traffic is *many* concurrent jobs with different key distributions on the
same fleet. Two things change at that scale:

* **The machine model.** Each job observes its own per-slot wave timings
  (one :class:`~repro_torch.core.slot_speeds.SlotSpeedEstimator` per job), and
  different jobs genuinely rank the slots differently — cache residency,
  kernel mix, expert affinity. Stacking the per-job speed rows yields a
  per-(job, slot) processing-time matrix: *unrelated processors*,
  ``R||C_max`` (Fotakis et al., arXiv 1312.4203), which
  :mod:`repro_torch.core.scheduler` now solves via ``proc_times=``.
* **The objective.** A fleet serving N tenants does not minimise one
  job's makespan; it minimises the *weighted completion time*
  ``Σ wᵢ Cᵢ``. With each job internally balanced by its own OS4M
  schedule, the coordinator's lever is admission **order** — Smith's
  rule (WSPT, :func:`repro_torch.core.simulator.wspt_order`) is exactly
  optimal for the sequential case and is what :meth:`plan_admission`
  applies to the live R-matrix estimates.

Execution keeps each job's tensors, estimator and
:class:`~repro_torch.core.schedule_cache.ScheduleCache` fully isolated (the
cache becomes a keyed multi-tenant resource —
:class:`~repro_torch.core.schedule_cache.MultiTenantScheduleCache`), so
interleaving jobs on one mesh is bit-identical to running each alone:
scheduling only ever moves *where* work runs, never what it computes.
Cross-job pipelining reuses the §4.4 double-buffer hooks
(:func:`repro_torch.core.pipeline.coschedule_waves`): one job's all-to-all
copy wave issues while another job's reduce wave computes, so the
overlap that already hides a single job's shuffle keeps working across
job boundaries.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import pipeline as pipe
from repro_torch.core import schedule_cache as sc
from repro_torch.core import simulator as sim

__all__ = ["ManagedJob", "MultiJobCoordinator"]


@dataclasses.dataclass
class ManagedJob:
    """One live tenant: the job, its priority weight, and its queue state.

    ``weight`` is the ΣwᵢCᵢ priority (bigger = finish sooner);
    ``pending`` holds submitted-but-unexecuted batches in arrival order;
    ``batch_seconds`` is an EWMA of the measured wall time per batch —
    the ``t_j`` that WSPT admission divides the weight by.
    """

    name: str
    job: Any                      # repro_torch.core.mapreduce.MapReduceJob
    weight: float = 1.0
    index: int = 0                # submission order (FIFO tie-break)
    pending: List[Any] = dataclasses.field(default_factory=list)
    results: List[Any] = dataclasses.field(default_factory=list)
    batch_seconds: Optional[float] = None
    completed_at: Optional[float] = None

    def observe_batch_seconds(self, seconds: float, ewma: float = 0.5) -> None:
        """Fold one measured batch wall time into the EWMA estimate."""
        if self.batch_seconds is None:
            self.batch_seconds = float(seconds)
        else:
            self.batch_seconds += ewma * (float(seconds) - self.batch_seconds)

    @property
    def estimated_seconds(self) -> float:
        """Estimated time to drain this job's queue (1.0/batch when cold)."""
        per_batch = 1.0 if self.batch_seconds is None else self.batch_seconds
        return per_batch * max(len(self.pending), 1)


class MultiJobCoordinator:
    """Holds N live MapReduce jobs and plans their shared-mesh execution.

    The coordinator is deliberately thin: each
    :class:`~repro_torch.core.mapreduce.MapReduceJob` keeps its own schedule,
    estimator and (tenant-keyed) schedule cache; the
    coordinator owns only the cross-job facts — the R-matrix view of
    everyone's measured slot speeds, the ΣwᵢCᵢ admission order, and the
    co-scheduled wave interleave.
    """

    def __init__(
        self,
        num_slots: int,
        policy: Optional[sc.ReusePolicy] = None,
    ):
        self.num_slots = int(num_slots)
        self.tenants = sc.MultiTenantScheduleCache(policy)
        self._jobs: Dict[str, ManagedJob] = {}

    # -- tenancy ------------------------------------------------------------

    def add_job(self, name: str, job, weight: float = 1.0) -> ManagedJob:
        """Admit a job under a unique tenant key.

        The job's slot count must match the coordinator's mesh. Its
        ScheduleCache (if any) is adopted into the multi-tenant cache
        under ``name``; a job arriving without one but with a
        coordinator-level default policy gets a fresh tenant cache
        attached. Either way, after admission the job's snapshots live
        under its own key — never another tenant's.
        """
        if name in self._jobs:
            raise ValueError(f"job {name!r} already admitted")
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        if job.cfg.num_slots != self.num_slots:
            raise ValueError(
                f"job {name!r} wants {job.cfg.num_slots} slots, "
                f"coordinator mesh has {self.num_slots}")
        if job.schedule_cache is not None:
            self.tenants.adopt(name, job.schedule_cache)
        elif self.tenants.default_policy is not None:
            job.attach_schedule_cache(self.tenants.tenant(name))
        handle = ManagedJob(
            name=name, job=job, weight=float(weight), index=len(self._jobs))
        self._jobs[name] = handle
        return handle

    def __getitem__(self, name: str) -> ManagedJob:
        return self._jobs[name]

    def __len__(self) -> int:
        return len(self._jobs)

    def jobs(self) -> List[ManagedJob]:
        """Managed jobs in admission order."""
        return list(self._jobs.values())

    def submit(self, name: str, batch) -> None:
        """Queue one batch of inputs for the named job."""
        self._jobs[name].pending.append(batch)

    # -- the R-matrix view --------------------------------------------------

    def r_matrix(
        self, loads: Optional[Sequence[float]] = None
    ) -> np.ndarray:
        """Per-(job, slot) processing times: stack each job's speed row.

        Row ``j`` is ``load_j / speeds[j, slot]`` from that job's *own*
        estimator (``MapReduceJob.proc_times_row``); ``+inf`` marks the
        slots the job cannot use (dead in its view of the mesh). This is
        the matrix the ``proc_times=`` schedulers and the admission
        planner consume. ``loads`` defaults to each job's estimated
        queue-drain seconds, so rows are commensurable.
        """
        handles = self.jobs()
        if loads is None:
            loads = [h.estimated_seconds for h in handles]
        loads = np.asarray(loads, dtype=np.float64)
        if loads.shape != (len(handles),):
            raise ValueError(
                f"loads must have shape ({len(handles)},), got {loads.shape}")
        rows = [h.job.proc_times_row(total_load=loads[j])
                for j, h in enumerate(handles)]
        return np.stack(rows) if rows else np.zeros((0, self.num_slots))

    def estimated_times(self) -> np.ndarray:
        """Estimated queue-drain seconds per job, via its R-matrix row.

        A job's whole queue runs on the mesh slice alive *in its own
        view*: the estimate spreads its measured per-batch seconds over
        the aggregate relative speed of the slots its row marks usable.
        """
        handles = self.jobs()
        times = np.zeros(len(handles))
        for j, h in enumerate(handles):
            load = h.estimated_seconds
            if load <= 0:
                continue
            row = h.job.proc_times_row(total_load=load)
            finite = np.isfinite(row)
            # row = load/speed per slot; aggregate speed = Σ (load/row).
            agg_speed = float(np.sum(load / row[finite]))
            alive = int(finite.sum())
            times[j] = (load * alive / agg_speed if agg_speed > 0 else load)
        return times

    # -- admission (Σ wᵢ Cᵢ) -------------------------------------------------

    def plan_admission(self, order: str = "wspt") -> List[str]:
        """Names in execution order: WSPT (Smith's rule) or FIFO baseline."""
        handles = self.jobs()
        if order == "fifo":
            return [h.name for h in handles]
        if order != "wspt":
            raise ValueError(f"unknown admission order {order!r}")
        times = self.estimated_times()
        weights = np.asarray([h.weight for h in handles])
        idx = sim.wspt_order(times, weights)
        return [handles[i].name for i in idx]

    def planned_weighted_completion(self, order: str = "wspt") -> float:
        """Predicted ``Σ wᵢ Cᵢ`` for an admission order (planning units)."""
        handles = self.jobs()
        times = self.estimated_times()
        weights = np.asarray([h.weight for h in handles])
        names = self.plan_admission(order)
        idx = [self._jobs[n].index for n in names]
        return sim.weighted_completion_time(times, weights, order=idx)

    # -- co-scheduled execution ----------------------------------------------

    def coschedule_plan(self) -> List[Tuple[int, int]]:
        """Cross-job wave interleave from the live snapshots' wave plans.

        Jobs whose tenant cache holds a planned snapshot contribute their
        §4.4 wave sequence; :func:`repro_torch.core.pipeline.coschedule_waves`
        merges them round-robin so consecutive waves alternate jobs — the
        issue order under which one job's a2a hides beneath another's
        reduce. Jobs still cold (no snapshot) contribute nothing yet.
        """
        plans = []
        for h in self.jobs():
            cache = h.job.schedule_cache
            snap = cache.snapshot if cache is not None else None
            if snap is not None and snap.waves is not None:
                plans.append(snap.waves)
        return pipe.coschedule_waves(plans)

    def run_queue(self, order: str = "wspt") -> Dict[str, Any]:
        """Drain every job's pending batches in the planned admission order.

        Jobs run back-to-back (each with its full OS4M-scheduled mesh). A
        port ``run()`` ends with the device→host copy of its outputs
        (``JobResult.values`` is numpy), so a job's completion time
        ``C_j`` is a host-clock time taken after its last batch's values
        reached the host; the next job's phase A starts only then. Returns
        telemetry:
        per-job completion seconds, the measured ``Σ wᵢ Cᵢ``, the
        admission order, and the cross-job overlap fraction of the
        co-scheduled wave plan.
        """
        names = self.plan_admission(order)
        t0 = time.perf_counter()
        in_flight: List[Tuple[ManagedJob, Any, float]] = []

        def drain() -> None:
            """Record the job's finished batches, stamping completions."""
            for handle, res, t_batch0 in in_flight:
                handle.results.append(res)
                handle.observe_batch_seconds(
                    time.perf_counter() - t_batch0)
                handle.completed_at = time.perf_counter() - t0
            in_flight.clear()

        for name in names:
            handle = self._jobs[name]
            batches, handle.pending = handle.pending, []
            for batch in batches:
                t_batch0 = time.perf_counter()
                res = handle.job.run(batch)
                in_flight.append((handle, res, t_batch0))
            drain()
        completions = {n: self._jobs[n].completed_at for n in names}
        weighted = sum(
            self._jobs[n].weight * (completions[n] or 0.0) for n in names)
        return {
            "order": names,
            "completions": completions,
            "weighted_completion": float(weighted),
            "coschedule_overlap": pipe.coschedule_overlap(
                self.coschedule_plan()),
            "cache": self.tenants.stats(),
        }

    def run_interleaved(
        self, sequence: Optional[List[str]] = None
    ) -> List[Tuple[str, Any]]:
        """Execute one pending batch at a time, alternating jobs.

        ``sequence`` gives the explicit (name, name, ...) batch order;
        None round-robins over jobs with pending batches. This is the
        finest-grained sharing mode — and the bit-identity property the
        tests pin: because every job's state is isolated (tensors,
        estimator, tenant schedule cache), the interleaved outputs equal the
        solo outputs bit for bit. Returns ``[(name, JobResult), ...]``.
        """
        if sequence is None:
            counts = {h.name: len(h.pending) for h in self.jobs()}
            sequence = []
            while any(c > 0 for c in counts.values()):
                for h in self.jobs():
                    if counts[h.name] > 0:
                        sequence.append(h.name)
                        counts[h.name] -= 1
        out: List[Tuple[str, Any]] = []
        for name in sequence:
            handle = self._jobs[name]
            if not handle.pending:
                raise ValueError(f"job {name!r} has no pending batch")
            batch = handle.pending.pop(0)
            res = handle.job.run(batch)
            handle.results.append(res)
            out.append((name, res))
        return out
