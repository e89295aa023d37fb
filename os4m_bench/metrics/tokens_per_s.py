"""tokens_per_s: the tokens served to the window's requests over the window
(every request the window starts is served to its end before it closes)."""
from os4m_bench.serve_work import tokens_per_s


def read(run):
    return tokens_per_s(run)
