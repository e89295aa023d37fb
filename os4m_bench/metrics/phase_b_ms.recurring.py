"""Phase B (MapReduceJob's spill, copy and reduce, to the outputs on the
host): the median of the program's own span over the traced jobs, in ms."""
from os4m_bench.readers import median_phase_ms


def read(run):
    return median_phase_ms(run, "phase_b")
