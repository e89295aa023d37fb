"""Phase B's rank sort (each received chunk put in pipeline-rank order):
the median over the traced jobs of the program's ``phase_b.rank_sort``
span, summed over the chunks, in ms of the stream's elapsed time over
each entry (first queued op to the end of the last), the card's idle
inside included."""
from os4m_bench.readers import median_phase_ms


def read(run):
    return median_phase_ms(run, "phase_b.rank_sort")
