"""OS4M sequence packing: documents → fixed-length rows by P||C_max.

The mapping: documents are operations (load = token length), the
``global_batch`` rows are slots, and max-load balance maximises real
tokens per row (minimises padding). The hash/round-robin baseline is the
paper's eq. 3-1 analogue. Documents longer than ``seq_len`` are split
(Map-side splitting is unconstrained — §3.1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core import scheduler as sched_lib

__all__ = ["PackingStats", "pack_documents"]


@dataclasses.dataclass
class PackingStats:
    real_tokens: int
    padded_tokens: int
    dropped_tokens: int
    balance_ratio: float

    @property
    def efficiency(self) -> float:
        total = self.real_tokens + self.padded_tokens
        return self.real_tokens / total if total else 0.0


def pack_documents(
    docs: Sequence[np.ndarray], batch: int, seq_len: int,
    scheduler: str = "os4m", pad_id: int = 0,
) -> Tuple[np.ndarray, PackingStats]:
    """Pack documents into a (batch, seq_len) array.

    Rows are filled in schedule order; per-row overflow beyond seq_len is
    dropped (drop-newest — counted). ``scheduler`` ∈ repro_torch.core.scheduler
    names; "hash" is the round-robin-class baseline.
    """
    pieces: List[np.ndarray] = []
    for d in docs:
        for off in range(0, d.shape[0], seq_len):
            pieces.append(d[off:off + seq_len])
    loads = np.asarray([p.shape[0] for p in pieces], dtype=np.float64)

    if scheduler in ("bss", "os4m"):
        sched = sched_lib.schedule_bss(loads, batch)
    elif scheduler == "lpt":
        sched = sched_lib.schedule_lpt(loads, batch)
    else:
        sched = sched_lib.schedule_hash(loads, batch,
                                        keys=np.arange(loads.shape[0]))

    out = np.full((batch, seq_len), pad_id, dtype=np.int32)
    dropped = 0
    real = 0
    for row in range(batch):
        members = np.nonzero(sched.assignment == row)[0]
        cur = 0
        for mi, m in enumerate(members):
            p = pieces[m]
            take = min(p.shape[0], seq_len - cur)
            out[row, cur:cur + take] = p[:take]
            cur += take
            dropped += p.shape[0] - take
            real += take
            if cur >= seq_len:
                # remaining members of an overfull row are dropped whole
                dropped += sum(pieces[m2].shape[0]
                               for m2 in members[mi + 1:])
                break
    return out, PackingStats(
        real_tokens=real,
        padded_tokens=batch * seq_len - real,
        dropped_tokens=dropped,
        balance_ratio=sched.balance_ratio,
    )
