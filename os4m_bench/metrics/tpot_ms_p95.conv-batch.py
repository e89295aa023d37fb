"""The 95th percentile over the window's requests of each request's time
per output token after its first, (last token - first token) / (tokens - 1),
on the host clock as the tokens reach it, in ms. A tail over some tens of
requests in a closed loop of batches: recorded, not judged."""
from os4m_bench.serve_work import tpot_ms_quantile


def read(run):
    return tpot_ms_quantile(run, 95)
