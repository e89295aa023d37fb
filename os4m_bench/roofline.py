"""The yardstick's peaks and the work a MapReduce job needs, from its shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W (dense
rates): a share is stated against them, with the card's ``power.limit``
beside it. Work is counted from the shapes of what has to be read and
written, each input byte once and each output byte once, whatever the
kernels that happen to do it read again. The counts are those behind
``PERF.md``'s kernel table (``chip_smoke.py:bound_ms`` and its callers),
frozen here.
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12     # HBM3 rate
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores
KEY_BYTES = 4                 # an int32 key hash
MASK_BYTES = 1                # a bool validity flag
VALUE_BYTES = 4               # a float32 value
COUNT_BYTES = 4               # a float32 pair count


@dataclasses.dataclass(frozen=True)
class Work:
    """Bytes to move and operations to compute."""

    nbytes: float
    ops: float

    def bound_s(self) -> float:
        """Least time on the card: max(bytes / memory rate, ops / float32 rate)."""
        return max(self.nbytes / HBM_BYTES_PER_S, self.ops / F32_OPS_PER_S)


def stats_work(slots: int, pairs_per_slot: int, clusters: int) -> Work:
    """Phase A's statistics (kernel 1): read every pair's key and validity,
    write the ``(m, n)`` float32 histogram; one add a pair."""
    pairs = slots * pairs_per_slot
    return Work(pairs * (KEY_BYTES + MASK_BYTES) + slots * clusters * COUNT_BYTES, pairs)


def reduce_work(valid_pairs: int, clusters: int, values_per_pair: int) -> Work:
    """Phase B's gather + segment sum (kernel 2): read every valid pair's
    values and its segment id once, write each cluster's sums and count
    once; ``V`` adds a pair."""
    row = values_per_pair * VALUE_BYTES + KEY_BYTES
    return Work((valid_pairs + clusters) * row, valid_pairs * values_per_pair)


def job_work(slots: int, pairs_per_slot: int, clusters: int, values_per_pair: int,
             valid_pairs: int) -> Work:
    """The whole job: read the input (keys, values, validity) once, write
    each cluster's sums and count once; ``V`` adds a valid pair."""
    pair = KEY_BYTES + values_per_pair * VALUE_BYTES + MASK_BYTES
    out = clusters * (values_per_pair * VALUE_BYTES + COUNT_BYTES)
    return Work(slots * pairs_per_slot * pair + out, valid_pairs * values_per_pair)
