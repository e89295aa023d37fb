"""job_ms_p95: the 95th percentile of all the window's job durations, in ms."""
from os4m_bench.readers import job_ms_quantile


def read(run):
    return job_ms_quantile(run, 95)
