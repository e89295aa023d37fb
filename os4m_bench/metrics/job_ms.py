"""job_ms: the window over the jobs completed in it, in ms (a recurring job)."""
from os4m_bench.readers import window_ms_per_job


def read(run):
    return window_ms_per_job(run)
