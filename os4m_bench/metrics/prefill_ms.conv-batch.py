"""The engine's admission: the median over the window of Engine.prefill_seconds
(an admitted prompt's prefill on every lane, to its first token on the host), in ms."""
from os4m_bench.serve_work import median_ms


def read(run):
    return median_ms(run.prefill_seconds)
