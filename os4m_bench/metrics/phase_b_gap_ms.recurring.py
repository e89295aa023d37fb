"""Phase B's host span less its four device stages' stream times (spill,
copy, rank sort, reduce), a job at a time: the part of phase B outside
the stages' intervals on the stream, namely the plan's uploads before the
spill, the lead-in to the spill's first op and the pulls after the last
stage ends. Idle of the card inside a stage's interval (the spill's
blocking uploads, a host-bound stretch) is in that stage's time, not
here. The median over the traced jobs, in ms."""
import statistics

KEYS = ("phase_b", "phase_b.spill", "phase_b.copy", "phase_b.rank_sort", "phase_b.reduce")


def read(run):
    gaps = [j.phase_ms[KEYS[0]] - sum(j.phase_ms[k] for k in KEYS[1:])
            for j in run.jobs if all(k in j.phase_ms for k in KEYS)]
    return statistics.median(gaps) if gaps else None
