"""Phase B's reduce (kernel 2, the gathers back to cluster order and the
merge of each chunk): the median over the traced jobs of the program's
``phase_b.reduce`` span, summed over the chunks, less the rank sort
inside it, in ms of the stream's elapsed time over each entry (first
queued op to the end of the last), the card's idle inside included."""
from os4m_bench.readers import median_phase_ms


def read(run):
    return median_phase_ms(run, "phase_b.reduce")
