"""The plan snapshot phase B executes: :class:`CachedSchedule`.

A :class:`CachedSchedule` holds everything the host produced for one
plan — the Q||C_max assignment (with the per-slot speeds it was built
for), the §4.4 wave plan, the statistics-sized send capacities, and the
per-shard ``K^(i)`` histograms the plan was derived from. Its JSON form is
the reference's, so a snapshot written by ``repro`` loads here and
executes to the same outputs.

The reuse machinery of the reference module (``drift_metric``,
``ReusePolicy``, ``ScheduleCache``, ``MultiTenantScheduleCache``) is
ROADMAP Queue 1 item 4; the elastic re-projection (``rebin_hist``,
``CachedSchedule.reproject``) is item 7.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import pipeline as pipe
from repro_torch.core import scheduler as sched_lib

__all__ = ["CachedSchedule"]


@dataclasses.dataclass
class CachedSchedule:
    """Everything phase B needs to replay one plan, plus its provenance.

    ``schedule`` + ``waves`` + the capacities fully determine phase B's
    shapes, and ``local_hist`` is the per-shard statistics the plan was
    derived from. ``key_dist`` is its shard-sum. :meth:`to_json` /
    :meth:`from_json` are a lossless pair and share the reference's
    layout.
    """

    schedule: sched_lib.Schedule
    strategy: str
    waves: pipe.WavePlan
    capacity: int                    # sequential-path per-(shard,dest) cap
    chunk_caps: Tuple[int, ...]      # per-wave caps (pipelined path)
    local_hist: np.ndarray           # (m, n) plan-time K^(i)
    key_dist: np.ndarray             # (n,)  plan-time K
    age: int = 0                     # batches executed with this plan
    k_per_shard: Optional[int] = None  # plan-time pairs per shard
    stats_provider: str = "exact"    # which provider produced local_hist
    stats_params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # True when every capacity came from overestimate-only statistics
    # (always, for exact statistics).
    stats_overestimate: bool = True
    # True when a chunk capacity was committed from a prefix estimate
    # (streaming-prefix planning, not ported yet).
    caps_estimated: bool = False

    def to_json(self) -> Dict[str, Any]:
        """Serialize plan + provenance to plain types (the reference's layout)."""
        out = {
            "assignment": self.schedule.assignment.tolist(),
            "num_slots": int(self.schedule.num_slots),
            "slot_speeds": [float(s) for s in self.schedule.slot_speeds],
            "strategy": self.strategy,
            "waves": self.waves.to_json(),
            "capacity": int(self.capacity),
            "chunk_caps": [int(c) for c in self.chunk_caps],
            "local_hist": self.local_hist.tolist(),
            "age": int(self.age),
            "k_per_shard": None if self.k_per_shard is None
            else int(self.k_per_shard),
            "stats": {
                "provider": self.stats_provider,
                "params": dict(self.stats_params),
                "overestimate": bool(self.stats_overestimate),
                "caps_estimated": bool(self.caps_estimated),
            },
        }
        if self.stats_provider != "exact":
            out["key_dist"] = [float(v) for v in np.asarray(self.key_dist)]
        return out

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "CachedSchedule":
        """Rebuild a snapshot from :meth:`to_json` output (either package's)."""
        local_hist = np.asarray(d["local_hist"], np.float64)
        stats = d.get("stats", {})
        provider = stats.get("provider", "exact")
        if "key_dist" in d:
            key_dist = np.asarray(d["key_dist"], np.float64)
        else:
            key_dist = local_hist.sum(axis=0)
        schedule = sched_lib.Schedule.from_assignment(
            np.asarray(d["assignment"], np.int32), key_dist, int(d["num_slots"]),
            speeds=d.get("slot_speeds"),
        )
        return CachedSchedule(
            schedule=schedule,
            strategy=d["strategy"],
            waves=pipe.WavePlan.from_json(d["waves"]),
            capacity=int(d["capacity"]),
            chunk_caps=tuple(int(c) for c in d["chunk_caps"]),
            local_hist=local_hist,
            key_dist=key_dist,
            age=int(d.get("age", 0)),
            k_per_shard=(None if d.get("k_per_shard") is None
                         else int(d["k_per_shard"])),
            stats_provider=provider,
            stats_params=dict(stats.get("params", {})),
            stats_overestimate=bool(stats.get("overestimate", True)),
            caps_estimated=bool(stats.get("caps_estimated", False)),
        )
