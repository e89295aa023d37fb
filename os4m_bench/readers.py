"""What the metric readers (``metrics/<name>.py``) share: each reader is one
call into here with its own kernels or phase, so that a new metric is a new
file of a few lines. A reader returns ``None`` where its run holds nothing
to read, and the harness then leaves the metric out of the line.
"""

from __future__ import annotations

import statistics
from typing import Optional

import numpy as np

from os4m_bench import roofline


def window_ms_per_job(run) -> Optional[float]:
    """The window's length over the jobs completed in it, in ms."""
    return run.window_s * 1e3 / len(run.jobs) if run.jobs else None


def job_ms_quantile(run, q: float) -> Optional[float]:
    """The ``q`` quantile (0-100, linear) of all the window's job durations, in ms."""
    if not run.jobs:
        return None
    return float(np.percentile([(j.end_s - j.start_s) * 1e3 for j in run.jobs], q))


def median_phase_ms(run, phase: str) -> Optional[float]:
    """The median over the window's jobs of the program's own host-clock
    span of ``phase`` (``MapReduceJob.last_phase_ms``)."""
    spans = [j.phase_ms[phase] for j in run.jobs if phase in j.phase_ms]
    return statistics.median(spans) if spans else None


def idle_share(run) -> Optional[float]:
    """The traced window's seconds with no operation on the device, in %."""
    if run.trace is None or not run.trace.events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def kernel_roofline(run, work_of_job, *kernels: str) -> Optional[float]:
    """The least time of the window's jobs' work (``work_of_job(run, job)``,
    a :class:`~os4m_bench.roofline.Work`) over the device time of the
    kernels named by ``kernels`` (see ``Trace.kernel_s``), in %."""
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s(*kernels)
    if seconds <= 0:
        return None
    return 100.0 * sum(work_of_job(run, j).bound_s() for j in run.jobs) / seconds


def stats_work(run, job) -> roofline.Work:
    """Kernel 1's work in one job."""
    m, k, n, _ = run.shape()
    return roofline.stats_work(m, k, n)


def reduce_work(run, job) -> roofline.Work:
    """Kernel 2's work in one job."""
    _, _, n, v = run.shape()
    return roofline.reduce_work(run.valid_pairs[job.batch], n, v)


def job_mfu(run) -> Optional[float]:
    """The least time of the window's jobs' whole work over the window, in %."""
    if run.trace is None or not run.jobs:
        return None
    m, k, n, v = run.shape()
    least = sum(roofline.job_work(m, k, n, v, run.valid_pairs[j.batch]).bound_s()
                for j in run.jobs)
    return 100.0 * least / run.window_s
