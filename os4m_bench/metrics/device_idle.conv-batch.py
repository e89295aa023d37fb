"""The device: the traced window's share with no operation running, in %."""
from os4m_bench.readers import idle_share


def read(run):
    return idle_share(run)
