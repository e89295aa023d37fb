"""The reuse decision (the drift on the device and its scalar pull): the
median over the traced jobs of the program's ``phase_a.decide`` span, in
host ms. Its scalar pull is the run's first wait on the card, so the span
holds the wait for phase A's queued device work (the map, the cluster
ids, kernel 1) besides the decision: it moves with kernel 1 too."""
from os4m_bench.readers import median_phase_ms


def read(run):
    return median_phase_ms(run, "phase_a.decide")
