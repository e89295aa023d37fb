"""The plan checker's real targets: snapshots of the port's own planner.

The reference's ``repro.analysis.targets`` also traces phase-B programs
for its jaxpr checkers; the port carries the plan half. Each target is
what :meth:`MapReduceJob._plan` (or the streaming-prefix
:meth:`MapReduceJob._plan_prefixed`) returns on synthetic-but-realistic
statistics — the reference's eight configurations and seeds: an LPT plan,
a pipelined BSS plan, a straggler (Q||C_max) plan, a dead-slot plan, a
coded r=2 plan, and the sketch-statistics plans (pure count-min and the
streaming-prefix two-step) whose snapshots exercise the validator's
overestimate-aware capacity rules. Planning is host work: the jobs are
made on the CPU and run nothing on a device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core import mapreduce as mr
from repro_torch.core import schedule_cache as sc


def plan_for(cfg: mr.MapReduceConfig, seed: int) -> sc.CachedSchedule:
    """The planner's snapshot of ``cfg`` on a seeded ``(m, n)`` histogram."""
    job = mr.MapReduceJob(lambda s: s, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, 64, size=(cfg.num_slots, cfg.num_clusters))
    hist = hist.astype(np.float64)
    k_per_shard = int(np.ceil(hist.sum(axis=1).max()))
    if cfg.stats == "sketch":
        # The planner consumes provider state — sketch the synthetic
        # histogram (count-min is linear, so from_dense == collect).
        state = job._stats.from_dense(hist)
        if cfg.stream_prefix is not None:
            # Prefix state: a thinner sample of the same distribution,
            # as the first stream_prefix of pairs would produce.
            noise = rng.uniform(0.5, 1.5, size=hist.shape)
            prefix = np.floor(hist * cfg.stream_prefix * noise)
            return job._plan_prefixed(
                state, job._stats.from_dense(prefix), k_per_shard)
        return job._plan(state, None, k_per_shard)
    return job._plan(hist, hist.sum(axis=0), k_per_shard)


def plan_targets() -> List[Tuple[str, sc.CachedSchedule]]:
    """Real planner outputs across scheduler / speed / coding variants."""
    cfg = mr.MapReduceConfig
    return [
        ("lpt-uniform", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt"),
                                 seed=0)),
        ("os4m-pipelined", plan_for(cfg(num_slots=4, num_clusters=12, scheduler="os4m",
                                        pipeline_chunks=3), seed=1)),
        ("lpt-straggler", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt",
                                       speeds=(1.0, 0.5, 1.0, 2.0)), seed=2)),
        ("lpt-dead-slot", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt",
                                       speeds=(1.0, 1.0, 0.0, 1.0)), seed=3)),
        ("coded-r2", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt",
                                  shuffle_replication=2), seed=4)),
        ("sketch-os4m", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="os4m",
                                     stats="sketch", sketch_width=64, sketch_depth=3),
                                 seed=5)),
        ("sketch-lpt", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt",
                                    stats="sketch", sketch_width=32, sketch_depth=4),
                                seed=6)),
        ("sketch-prefix", plan_for(cfg(num_slots=4, num_clusters=16, scheduler="lpt",
                                       stats="sketch", sketch_width=64, sketch_depth=3,
                                       stream_prefix=0.25), seed=7)),
    ]
