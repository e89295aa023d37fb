"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result.

The window drives ``repro_torch.core.mapreduce.MapReduceJob.run`` in a
closed loop, one job in flight: job ``i`` runs pool batch ``i mod P`` and
ends when its ``JobResult`` is on the host. It starts no job once
``seconds`` have passed, and closes when the last job has ended. The peak
memory is read there. Every pool batch's keys are the traffic's
``shape_seed``'s, shared by every seed; so that a fault which follows the
key draw (capacities, overflow, placement) can show, the same job then
runs one batch drawn wholly from the seed twice: under the window's plan,
and under a cold plan of its own. Once the job is freed, every job of the
window and both of these are held against the reference of their batch
(``reference.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from os4m_bench import reference, traffic as traffic_lib
from os4m_bench.spec import ROOT, Cell
from os4m_bench.trace import DeviceTracer, Trace

# Top-level module names the measured process may not hold: JAX and the
# JAX package of this repository (``repro``; ``repro_torch`` is the port).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

# The limit of each compared number. Counts, statistics and the plan are
# exact. ``values_gap`` (see ``values_gap``) is float32 summation against
# float64: its limit lies between the sound runs' readings and those of
# the program's fp8 and int8 wires (PERF.md, "Correctness").
LIMITS = {"values_gap": 1e-3, "counts_gap": 0.0, "stats_gap": 0.0, "plan_faults": 0.0}


@dataclasses.dataclass
class Job:
    """One job of the window, on the host clock from the window's start."""

    batch: int
    start_s: float
    end_s: float
    phase_ms: dict                 # the program's own spans (last_phase_ms)


@dataclasses.dataclass
class Run:
    """What the metric readers (``metrics/*.py``) read."""

    config: dict
    jobs: List[Job]
    window_s: float
    setup_s: float
    valid_pairs: List[int]         # of each pool batch
    trace: Optional[Trace] = None

    def shape(self) -> tuple:
        """``(slots, pairs_per_slot, clusters, values_per_pair)``."""
        c = self.config
        return (int(c["slots"]), int(c["pairs_per_slot"]), int(c["clusters"]),
                int(c["values_per_pair"]))


def forbidden_modules(names) -> list:
    """The names among ``names`` whose top-level part (before the first dot)
    is one of :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN_MODULES})


def program():
    """The port's entry points (``src/`` of the checkout on the path)."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core.mapreduce import MapReduceConfig, MapReduceJob
    from repro_torch.core.schedule_cache import ReusePolicy
    return MapReduceConfig, MapReduceJob, ReusePolicy


def make_job(config: dict, traffic: dict, device):
    """The job a cell drives: the configuration's engine settings, the
    traffic's reuse policy, an identity map over the drawn pairs."""
    MapReduceConfig, MapReduceJob, ReusePolicy = program()
    reuse = traffic.get("reuse")
    cfg = MapReduceConfig(num_slots=int(config["slots"]), num_clusters=int(config["clusters"]),
                          reuse=None if reuse is None else ReusePolicy(**reuse),
                          **config["engine"])
    return MapReduceJob(lambda batch: batch, cfg, device=device, backend=config["backend"])


def values_gap(got: np.ndarray, sums: np.ndarray, squares: np.ndarray) -> float:
    """The largest gap of a cluster's sum from the reference's, over the
    root of that cluster's sum of squares (1 for a cluster with no pairs):
    a wire that rounds every value by a relative ``e`` reads about ``e``."""
    scale = np.sqrt(squares)
    scale[scale == 0] = 1.0
    return float(np.max(np.abs(got - sums) / scale))


def compare(results: list, refs: list) -> tuple:
    """Each job's ``(batch, JobResult)`` against its batch's reference
    ``(sums, squares, counts)``: ``(gaps, failed jobs)``. A gap is the
    largest over the jobs: ``values_gap`` as :func:`values_gap` says,
    ``counts_gap`` and ``stats_gap`` the largest absolute difference of
    ``counts`` and ``key_distribution``; ``plan_faults`` counts jobs whose
    plan put a cluster on no slot or dropped a pair."""
    gaps = dict.fromkeys(LIMITS, 0.0)
    failed = 0
    for b, res in results:
        sums, squares, counts = refs[b]
        got = np.asarray(res.values, dtype=np.float64)
        job = {"values_gap": (values_gap(got, sums, squares) if got.shape == sums.shape
                              else float("inf")),
               "plan_faults": 0.0}
        for name, got, want in (("counts_gap", res.counts, counts),
                                ("stats_gap", res.key_distribution, counts)):
            got = np.asarray(got, dtype=np.float64)
            job[name] = (float(np.max(np.abs(got - want))) if got.shape == want.shape
                         else float("inf"))
        assignment = np.asarray(res.schedule.assignment)
        m = int(res.schedule.num_slots)
        if (assignment.shape != counts.shape or assignment.min() < 0
                or assignment.max() >= m or res.overflow != 0):
            job["plan_faults"] = 1.0
        failed += any(job[k] > LIMITS[k] for k in LIMITS)
        for k in ("values_gap", "counts_gap", "stats_gap"):
            gaps[k] = max(gaps[k], job[k])
        gaps["plan_faults"] += job["plan_faults"]
    return gaps, failed


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             setup_start: float, job_factory: Callable = make_job) -> dict:
    """One run of ``cell``; returns the result line's object.

    ``setup_start`` is the host clock at the process's start: set-up runs
    from it to the window's start. ``job_factory(config, traffic, device)``
    makes the job (a test passes a broken one)."""
    on_cuda = torch.device(device).type == "cuda"
    config, mix = cell.config, cell.traffic
    pool = traffic_lib.draw_pool(config, mix, seed, device)
    job = job_factory(config, mix, device)
    warmup = int(mix["warmup_jobs"])
    for i in range(warmup):
        job.run(pool[i % len(pool)].inputs())
    if on_cuda:
        torch.cuda.synchronize(device)

    jobs, results = [], []
    tracer = DeviceTracer(device) if trace else None
    with tracer or contextlib.nullcontext():
        t_start = tracer.start if tracer else time.perf_counter()
        setup_s = t_start - setup_start
        i = warmup
        while time.perf_counter() - t_start < seconds:
            b = i % len(pool)
            t0 = time.perf_counter()
            res = job.run(pool[b].inputs())
            t1 = time.perf_counter()
            jobs.append(Job(b, t0 - t_start, t1 - t_start, dict(job.last_phase_ms or {})))
            results.append((b, res))
            i += 1
        window_s = time.perf_counter() - t_start
    if tracer:
        window_s = tracer.end - tracer.start
    memory_peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0

    fresh = traffic_lib.draw_fresh(config, seed, device)
    results.append((len(pool), job.run(fresh.inputs())))
    if getattr(job, "schedule_cache", None) is not None:
        job.attach_schedule_cache(type(job.schedule_cache)(job.schedule_cache.policy))
        results.append((len(pool), job.run(fresh.inputs())))
    del job
    if on_cuda:
        torch.cuda.empty_cache()
    refs = [reference.reduce_sum(*b.inputs(), int(config["clusters"]))
            for b in pool + [fresh]]
    gaps, failed = compare(results, refs)

    run = Run(config, jobs, window_s, setup_s, [p.valid_pairs for p in pool],
              tracer.trace if tracer else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    device_info = {"platform": "gpu" if on_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(jobs) and failed == 0 and all(
               gaps[k] <= LIMITS[k] for k in LIMITS),
           "attempted": len(results), "failed": failed, "metrics": metrics,
           "device": device_info}
    if run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        spans = host_spans(jobs)
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps(spans)}
    out["checks"] = {k: {"value": gaps[k], "limit": LIMITS[k]} for k in LIMITS}
    return out


def host_spans(jobs: List[Job]) -> list:
    """``(label, start_s, end_s)`` of each job's phases, as the program
    times them (phase A ends where the statistics reach the host, the plan
    follows, then phase B, which holds the host's merge), and the return
    from ``MapReduceJob.run`` after them."""
    spans = []
    for j in jobs:
        t = j.start_s
        for phase in ("phase_a", "plan", "phase_b"):
            ms = j.phase_ms.get(phase)
            if ms is None:
                continue
            spans.append((phase, t, t + ms / 1e3))
            t += ms / 1e3
        spans.append(("return", t, j.end_s))
    return spans
