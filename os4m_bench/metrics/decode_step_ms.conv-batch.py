"""The engine's decode loop: the median over the window of Engine.step_seconds
(one lock-step decode of every lane, to its tokens on the host), in ms."""
from os4m_bench.serve_work import median_ms


def read(run):
    return median_ms(run.step_seconds)
