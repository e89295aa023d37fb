"""The whole job's share of the card's peak: the least time of its work
(the inputs read once, the outputs written once, at 3.35 TB/s) over the
traced window's time a job, in %."""
from os4m_bench.readers import job_mfu


def read(run):
    return job_mfu(run)
