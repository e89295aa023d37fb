"""Phase A's device stage (the map, the cluster ids and kernel 1): the
median over the traced jobs of the program's ``phase_a.map_stats`` span,
in ms of the stream's elapsed time from the stage's first queued op to
the end of its last, the card's idle inside that interval included."""
from os4m_bench.readers import median_phase_ms


def read(run):
    return median_phase_ms(run, "phase_a.map_stats")
