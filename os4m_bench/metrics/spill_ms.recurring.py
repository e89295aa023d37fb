"""Phase B's spill (the wire's payload and the counting sort into every
chunk's buckets): the median over the traced jobs of the program's
``phase_b.spill`` span, in ms of the stream's elapsed time from the
stage's first queued op to the end of its last. The card's idle inside
that interval is included: the spill's two blocking uploads, and any
stretch where the host enqueues its ops more slowly than the card runs
them."""
from os4m_bench.readers import median_phase_ms


def read(run):
    return median_phase_ms(run, "phase_b.spill")
