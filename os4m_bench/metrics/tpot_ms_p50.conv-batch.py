"""The median over the window's requests of each request's time per output
token after its first, (last token - first token) / (tokens - 1), on the
host clock as the tokens reach it, in ms: a decode step and the admissions'
prefills that stalled the request's lane on the way."""
from os4m_bench.serve_work import tpot_ms_quantile


def read(run):
    return tpot_ms_quantile(run, 50)
