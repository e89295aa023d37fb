"""Phase B's copy (each chunk's buckets transposed to their receivers):
the median over the traced jobs of the program's ``phase_b.copy`` span,
summed over the chunks, in ms of the stream's elapsed time over each
entry (first queued op to the end of the last), the card's idle inside
included."""
from os4m_bench.readers import median_phase_ms


def read(run):
    return median_phase_ms(run, "phase_b.copy")
