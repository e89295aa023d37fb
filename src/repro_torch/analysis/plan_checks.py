"""Plan validator: structural invariants of the host planner's outputs.

Pure-Python checks over the port's ``Schedule`` / ``WavePlan`` /
``CachedSchedule`` — the objects every phase-B shape and wire format is
derived from — and its ``SketchStats.send_bound``; the reference's
validator, rule for rule. The rules mirror what the executors *assume*
without re-checking:

* **cluster-not-placed-once** — ``chunk_of_cluster`` must put every
  operation cluster in exactly one wave with dense chunk ids, and
  ``rank_of_cluster`` must be a permutation (it is the sort key of the
  fused kernel's stream; a repeated rank merges two clusters' records).
* **dead-slot-loaded** — a slot with speed exactly ``0.0`` has vanished
  from the mesh (elastic-mesh semantics); any assignment or load on it
  is work sent to a machine that no longer exists.
* **invalid-pairing** — the coded shuffle's partner schedule
  ``π(s, j) = (s + 1 + (j mod (m-1))) mod m`` must cover every other
  slot exactly once per sender; otherwise some pair's XOR packet is
  never decodable.
* **chunk-cap-undersized** — send capacities were statistics-sized from
  the plan-time ``K^(i)``; a cap below the exact per-(shard, dest) worst
  case guarantees overflow on the very distribution the plan was built
  for (slack and quantization only ever round *up*). When the snapshot
  was planned from a count-min sketch (``stats_provider == "sketch"``)
  the floor is recomputed with the provider's own distinct-bin bound
  (``SketchStats.send_bound`` — the exact computation the caps were
  committed from) — valid only because the snapshot records an
  overestimate-only provider, so the bound floors the exact worst case
  from above. Snapshots with
  ``caps_estimated`` set committed a deliberately optimistic wave-1 cap
  (streaming prefix) and are exempt: the runtime escape hatch re-executes
  with safe caps on overflow.
* **sketch-caps-unguarded** — a sketch-planned snapshot that neither
  claims the overestimate-only guarantee nor arms the overflow escape
  hatch has no defence against undersized caps at all.
* **snapshot-not-roundtrip** — ``CachedSchedule.to_json`` →
  ``from_json`` → ``to_json`` must be a fixed point, or a persisted plan
  replays with different shapes than it was planned with.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.analysis.report import Finding


def _finding(rule: str, target: str, summary: str, evidence) -> Finding:
    return Finding(checker="plan", rule=rule, target=target,
                   summary=summary, evidence=list(evidence))


def coded_partner(s: int, j: int, m: int) -> int:
    """The engine's coded-shuffle pairing π (see ``core.mapreduce``)."""
    return (s + 1 + (j % (m - 1))) % m


def validate_wave_plan(plan, num_clusters: int, target: str) -> List[Finding]:
    """Wave-plan invariants: permutation rank, dense one-shot chunk ids."""
    findings: List[Finding] = []
    n = num_clusters
    rank = np.asarray(plan.rank_of_cluster)
    chunk = np.asarray(plan.chunk_of_cluster)
    if rank.shape != (n,) or sorted(rank.tolist()) != list(range(n)):
        findings.append(_finding(
            "rank-not-permutation", target,
            "rank_of_cluster is not a permutation of the clusters — the "
            "fused kernel's sort key would merge or drop clusters",
            [f"rank_of_cluster={rank.tolist()}", f"expected a permutation of 0..{n - 1}"],
        ))
    if chunk.shape != (n,) or chunk.size == 0 or \
            chunk.min() < 0 or chunk.max() >= plan.num_chunks:
        findings.append(_finding(
            "chunk-id-out-of-range", target,
            "chunk_of_cluster assigns a cluster outside [0, num_chunks) — "
            "that cluster's records travel in no wave",
            [f"chunk_of_cluster={chunk.tolist()}",
             f"num_chunks={plan.num_chunks}"],
        ))
    else:
        empty = [c for c in range(plan.num_chunks)
                 if not np.any(chunk == c)]
        if empty:
            findings.append(_finding(
                "chunk-id-not-dense", target,
                "some waves are empty — the executor scans num_chunks "
                "waves and an empty one is a silent no-op stage",
                [f"empty chunks: {empty} of num_chunks={plan.num_chunks}"],
            ))
    if plan.replication not in (1, 2):
        findings.append(_finding(
            "bad-replication", target,
            "wave-plan replication must be 1 (unicast) or 2 (XOR pairs)",
            [f"replication={plan.replication}"],
        ))
    return findings


def validate_membership(member_lists: Sequence[Sequence[int]],
                        num_clusters: int, target: str) -> List[Finding]:
    """Every cluster must appear in exactly one wave's member list."""
    counts = np.zeros(num_clusters, dtype=np.int64)
    stray: List[int] = []
    for members in member_lists:
        for j in members:
            if 0 <= int(j) < num_clusters:
                counts[int(j)] += 1
            else:
                stray.append(int(j))
    missing = np.nonzero(counts == 0)[0].tolist()
    dup = np.nonzero(counts > 1)[0].tolist()
    if not (stray or missing or dup):
        return []
    return [_finding(
        "cluster-not-placed-once", target,
        "wave membership does not place every cluster exactly once",
        [f"missing clusters: {missing}",
         f"multiply-placed clusters: {dup}",
         f"out-of-range members: {stray}"],
    )]


def validate_pairing(m: int, replication: int, target: str) -> List[Finding]:
    """r=2 only: π must give every sender all other slots as partners."""
    if replication != 2:
        return []
    if m < 2:
        return [_finding(
            "invalid-pairing", target,
            "coded r=2 needs at least 2 slots to form multicast pairs",
            [f"num_slots={m}"],
        )]
    findings: List[Finding] = []
    for s in range(m):
        partners = {coded_partner(s, j, m) for j in range(m - 1)}
        expect = set(range(m)) - {s}
        if partners != expect:
            findings.append(_finding(
                "invalid-pairing", target,
                f"sender {s}'s partner schedule misses some slots — their "
                "XOR packets are never decodable",
                [f"partners under π: {sorted(partners)}",
                 f"expected: {sorted(expect)}"],
            ))
    return findings


def validate_schedule(schedule, target: str) -> List[Finding]:
    """Assignment range + dead slots (speed 0.0) carry exactly nothing."""
    findings: List[Finding] = []
    m = int(schedule.num_slots)
    a = np.asarray(schedule.assignment)
    if a.size and (a.min() < 0 or a.max() >= m):
        findings.append(_finding(
            "assignment-out-of-range", target,
            "an operation is assigned to a slot id outside [0, num_slots)",
            [f"assignment={a.tolist()}", f"num_slots={m}"],
        ))
        return findings
    speeds = schedule.slot_speeds
    if speeds is not None:
        for s in np.nonzero(np.asarray(speeds) == 0.0)[0]:
            assigned = np.nonzero(a == s)[0].tolist()
            load = float(np.asarray(schedule.slot_loads)[s])
            if assigned or load != 0.0:
                findings.append(_finding(
                    "dead-slot-loaded", target,
                    f"slot {int(s)} has speed 0.0 (left the mesh) but "
                    "still carries work — it will never finish",
                    [f"assigned clusters: {assigned}",
                     f"slot_loads[{int(s)}]={load}"],
                ))
    return findings


def _chunk_floor(snap, members, per_shard) -> int:
    """Per-(shard, dest) worst-case sends for one wave, no slack.

    ``per_shard`` is the ``(m, n)`` plan-time count matrix: the exact
    histogram for exact providers, or the count-min *estimates* for
    sketch providers (an upper bound on the exact floor, see module doc).
    """
    members = np.asarray(members, dtype=np.int64)
    if members.size == 0:
        return 0
    m = int(snap.schedule.num_slots)
    dests = np.asarray(snap.schedule.assignment)[members]
    worst = 0.0
    for i in range(m):
        per_dest = np.bincount(dests, weights=per_shard[i, members],
                               minlength=m)
        worst = max(worst, float(per_dest.max()))
    return int(math.ceil(worst))


def _rebuild_sketch(snap, n: int):
    """Rebuild the snapshot's ``SketchStats`` provider from its params.

    The validator must size its floor with the *same* distinct-bin bound
    the planner committed caps from (``SketchStats.send_bound``) — a
    different overestimate could legitimately exceed a committed cap and
    manufacture a false finding. Returns ``None`` when the recorded
    params don't describe the stored cells.
    """
    from repro_torch.core.stats_provider import SketchStats

    p = snap.stats_params
    try:
        prov = SketchStats(n, width=int(p["width"]), depth=int(p["depth"]),
                           seed=int(p.get("seed", 0)))
    except (KeyError, TypeError, ValueError):
        return None
    cells = np.asarray(snap.local_hist)
    if cells.ndim != 2 or cells.shape[1] != prov.state_size:
        return None
    return prov


def validate_snapshot(snap, target: str) -> List[Finding]:
    """All invariants of one ``CachedSchedule``, including caps + JSON."""
    provider = getattr(snap, "stats_provider", "exact")
    if provider == "exact":
        n = int(np.asarray(snap.local_hist).shape[1])
    else:
        # Sketch snapshots carry (m, depth*width) cells, not per-cluster
        # columns — the cluster count lives in the assignment vector.
        n = int(np.asarray(snap.schedule.assignment).shape[0])
    m = int(snap.schedule.num_slots)
    findings = []
    findings += validate_schedule(snap.schedule, target)
    findings += validate_wave_plan(snap.waves, n, target)
    findings += validate_membership(
        [snap.waves.chunk_members(c) for c in range(snap.waves.num_chunks)],
        n, target)
    findings += validate_pairing(m, snap.waves.replication, target)

    # Statistics-sized capacities: slack and octave quantization only
    # round up, so every cap must clear the worst case computed from the
    # very statistics the plan snapshot carries — the exact histograms,
    # or (overestimate-only providers) the count-min estimates the caps
    # were sized from. Only trusted while the f32-accumulated raw
    # counters are integer-exact.
    raw = np.asarray(snap.local_hist)
    hist_exact = (float(raw.max()) if raw.size else 0.0) < float(2 ** 24) - 1.0
    wave_floor = None
    if hist_exact:
        if provider == "exact":
            per_shard = np.asarray(snap.local_hist, np.float64)

            def wave_floor(members):
                return _chunk_floor(snap, members, per_shard)
        elif getattr(snap, "caps_estimated", False):
            # Streaming-prefix plans commit an optimistic wave-1 cap on
            # purpose; the runtime escape hatch covers the overflow case.
            wave_floor = None
        elif getattr(snap, "stats_overestimate", True):
            sketch = _rebuild_sketch(snap, n)
            if sketch is not None:
                cells = np.asarray(snap.local_hist, np.float64)
                assign = np.asarray(snap.schedule.assignment)

                def wave_floor(members):
                    members = np.asarray(members, np.int64)
                    if members.size == 0:
                        return 0
                    return int(math.ceil(sketch.send_bound(
                        cells, assign[members], members, m)))
        else:
            findings.append(_finding(
                "sketch-caps-unguarded", target,
                "sketch-planned snapshot neither claims the "
                "overestimate-only guarantee nor arms the overflow "
                "escape hatch — undersized caps would go undetected",
                [f"stats_provider={provider}",
                 "stats_overestimate=False", "caps_estimated=False"],
            ))
    if wave_floor is not None:
        for c in range(snap.waves.num_chunks):
            if c >= len(snap.chunk_caps):
                findings.append(_finding(
                    "chunk-cap-missing", target,
                    "fewer chunk_caps than waves — a wave has no capacity",
                    [f"num_chunks={snap.waves.num_chunks}",
                     f"chunk_caps={list(snap.chunk_caps)}"],
                ))
                break
            floor = min(int(snap.capacity),
                        wave_floor(snap.waves.chunk_members(c)))
            if int(snap.chunk_caps[c]) < floor:
                findings.append(_finding(
                    "chunk-cap-undersized", target,
                    f"wave {c}'s send cap is below the worst case of "
                    "its own plan-time statistics — guaranteed "
                    "overflow on the planned distribution",
                    [f"chunk_caps[{c}]={int(snap.chunk_caps[c])}",
                     f"plan-time per-(shard,dest) worst case: {floor}",
                     f"capacity={int(snap.capacity)}"],
                ))
            if int(snap.chunk_caps[c]) > int(snap.capacity):
                findings.append(_finding(
                    "chunk-cap-exceeds-capacity", target,
                    f"wave {c}'s cap exceeds the sequential capacity the "
                    "buffers are sized from",
                    [f"chunk_caps[{c}]={int(snap.chunk_caps[c])}",
                     f"capacity={int(snap.capacity)}"],
                ))

    findings += validate_roundtrip(snap, target)
    return findings


def validate_roundtrip(snap, target: str) -> List[Finding]:
    """to_json → from_json → to_json must be a fixed point."""
    from repro_torch.core.schedule_cache import CachedSchedule

    d1 = snap.to_json()
    d2 = CachedSchedule.from_json(d1).to_json()
    if d1 == d2:
        return []
    diff = [k for k in sorted(set(d1) | set(d2))
            if d1.get(k) != d2.get(k)]
    return [_finding(
        "snapshot-not-roundtrip", target,
        "CachedSchedule does not survive JSON round-trip — a persisted "
        "plan would replay with different shapes than it was planned with",
        [f"fields that changed: {diff}"]
        + [f"  {k}: {d1.get(k)!r} -> {d2.get(k)!r}" for k in diff[:4]],
    )]


def check_plans(plans: Sequence[Tuple[str, object]]) -> List[Finding]:
    """Validate every (name, CachedSchedule) the real planner produced."""
    findings: List[Finding] = []
    for name, snap in plans:
        findings.extend(validate_snapshot(snap, name))
    return findings
