"""The whole step: the operations that the window's served requests need
(each prompt token and each served token once through the model, causal
attention, the head once a served token) over the window at the bfloat16
peak, in %."""
from os4m_bench.serve_work import serve_mfu


def read(run):
    return serve_mfu(run)
