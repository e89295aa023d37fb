"""Mutation self-tests: seeded violations every checker must catch.

A static analyzer that has never seen a violation is indistinguishable
from one that checks nothing. Each case here *constructs* a known-bad
program / plan / source file — the exact bug class a checker claims to
certify against — runs only the analyzer on it, and demands a finding
from the intended checker, with the intended rule, carrying non-empty
evidence. The catalog is the reference's (``repro.analysis.mutations``),
case for case, under its names:

* phase-B bodies recorded like the real ones (the engine's ``_spill`` and
  ``_reduce_received`` under the engine's stacked runner): a chunk-``c+1``
  copy fed from reduce(``c``)'s output (the §4.4 overlap killer); a
  reduce that reads the original segment row instead of the stamped one,
  and a stamp taken before any copy; ``argsort(stable=False)`` on the
  spill's input; a ``.item()`` from an unregistered function;
* a launch geometry whose tile rows derive from the slab length;
* plans with a duplicated rank, an out-of-range chunk id, a double-placed
  cluster, a loaded dead slot, undersized chunk caps (exact *and*
  sketch-planned — the latter exercises the count-min estimate floor), a
  sketch snapshot stripped of both the overestimate-only claim and the
  escape hatch, and a lossy JSON snapshot;
* source files with a clock in a captured body (the reference's
  ``jitted-time-call``, whose port rule is C1 ``capture-rng-time``), a
  default-stability wire sort, and an unmarked host sync.

``run_self_tests()`` is wired into ``--self-test``: a checker that goes
blind fails the run, not just the review.
"""

from __future__ import annotations

import dataclasses
import pathlib
import tempfile
import textwrap
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import conventions, determinism, overlap, plan_checks
from repro_torch.analysis import targets as tgt
from repro_torch.analysis.report import Finding
from repro_torch.core import mapreduce as mr


@dataclasses.dataclass
class SelfTestResult:
    """One mutation case: did the intended checker catch it with evidence?"""

    name: str
    checker: str
    rule: str
    caught: bool
    findings: List[Finding]

    def render(self) -> str:
        mark = "caught" if self.caught else "MISSED"
        return f"{mark:7s} {self.name} -> [{self.checker}:{self.rule}]"


# --------------------------------------------------------------------------
# Recorded mutants: phase-B bodies with the engine's protocol
# (``_phase_b_body``'s signature, yields and outputs).
# --------------------------------------------------------------------------


def _mutant_target(name: str, body, timed: bool = False, device="cpu"):
    static = tgt.static_of(True) if body is _chain_body else tgt.static_of(False)
    return tgt.record(name, tgt._phase_b(static, torch.device(device), timed=timed, body=body),
                      timed=timed)


def _spilled(intermediate, plan, static, me):
    """The engine's spill of ``intermediate`` on the exact wire."""
    send, _, _ = mr._spill(intermediate, *plan, static, me, intermediate[1], intermediate[1])
    return send


def _chain_body(intermediate, assignment, rank_of_cluster, chunk_of_cluster, static, me,
                stamp_through=None):
    """Pipelined walk whose copy of chunk c+1 waits on reduce(c)'s output."""
    (_, n, _, _, reduce_op, _, num_chunks, _) = static
    plan = (assignment, rank_of_cluster, chunk_of_cluster)
    send = _spilled(intermediate, plan, static, me)
    yield ("spill", send)
    acc = cnt = None
    for c in range(num_chunks):
        recv = yield ("copy", c)
        out_c, cnt_c = mr._reduce_received(send, recv, plan, n, reduce_op)
        if c + 1 < num_chunks:
            send.keys.add_((out_c.sum() * 0).to(send.keys.dtype))  # BUG: copy(c+1) reads it
        acc = out_c if acc is None else acc + out_c
        cnt = cnt_c if cnt is None else cnt + cnt_c
    return acc, cnt


def _dropped_body(intermediate, assignment, rank_of_cluster, chunk_of_cluster, static, me,
                  stamp_through=None):
    """Timed single wave whose reduce reads the original ids, not the stamped."""
    (_, n, _, _, reduce_op, _, _, _) = static
    plan = (assignment, rank_of_cluster, chunk_of_cluster)
    send = _spilled(intermediate, plan, static, me)
    yield ("spill", send)
    seg = yield ("copy", 0)
    _stamped, start = stamp_through(seg)
    out, counts = mr._reduce_received(send, seg, plan, n, reduce_op)   # BUG: seg
    out, end = stamp_through(out, counts)
    return out, counts, mr._tick_pairs([start, end])


def _unanchored_body(intermediate, assignment, rank_of_cluster, chunk_of_cluster, static, me,
                     stamp_through=None):
    """Timed single wave with a stamp taken before any copy."""
    (_, n, _, _, reduce_op, _, _, _) = static
    plan = (assignment, rank_of_cluster, chunk_of_cluster)
    key_hashes, values, valid = intermediate
    key_hashes, early = stamp_through(key_hashes)      # BUG: no wave's data exists yet
    send = _spilled((key_hashes, values, valid), plan, static, me)
    yield ("spill", send)
    seg = yield ("copy", 0)
    out, counts = mr._reduce_received(send, seg, plan, n, reduce_op)
    out, end = stamp_through(out, counts)
    return out, counts, mr._tick_pairs([early, end])


def _unstable_body(intermediate, assignment, rank_of_cluster, chunk_of_cluster, static, me,
                   stamp_through=None):
    """Single wave whose spill input is ordered by an unstable sort."""
    (_, n, _, _, reduce_op, _, _, _) = static
    plan = (assignment, rank_of_cluster, chunk_of_cluster)
    key_hashes, values, valid = intermediate
    group = mr._cluster_ids(key_hashes, n)
    order = torch.argsort(group, dim=1, stable=False)   # BUG: ties reorder freely
    ordered = (key_hashes.gather(1, order),
               values.gather(1, order[..., None].expand_as(values)), valid.gather(1, order))
    send = _spilled(ordered, plan, static, me)
    yield ("spill", send)
    seg = yield ("copy", 0)
    return mr._reduce_received(send, seg, plan, n, reduce_op)


def _rogue_peek(x: torch.Tensor) -> float:
    """An UNREGISTERED host sync (intentionally not allowlisted)."""
    return x.sum().item()


def _rogue_body(intermediate, assignment, rank_of_cluster, chunk_of_cluster, static, me,
                stamp_through=None):
    """Single wave that reads a value back to the host mid-program."""
    (_, n, _, _, reduce_op, _, _, _) = static
    plan = (assignment, rank_of_cluster, chunk_of_cluster)
    send = _spilled(intermediate, plan, static, me)
    yield ("spill", send)
    seg = yield ("copy", 0)
    _rogue_peek(seg)                                    # BUG: undeclared host sync
    return mr._reduce_received(send, seg, plan, n, reduce_op)


def _mutant_a2a_chain(device="cpu"):
    return overlap.check_overlap([_mutant_target("mutant-a2a-chain", _chain_body,
                                                 device=device)])


def _mutant_stamp_dropped(device="cpu"):
    return overlap.check_overlap([_mutant_target("mutant-stamp-dropped", _dropped_body,
                                                 timed=True, device=device)])


def _mutant_stamp_unanchored(device="cpu"):
    return overlap.check_overlap([_mutant_target("mutant-stamp-unanchored", _unanchored_body,
                                                 timed=True, device=device)])


def _mutant_unstable_sort(device="cpu"):
    return determinism.check_determinism([_mutant_target("mutant-unstable-sort",
                                                         _unstable_body, device=device)])


def _mutant_rogue_callback(device="cpu"):
    return determinism.check_determinism([_mutant_target("mutant-rogue-callback",
                                                         _rogue_body, device=device)])


def _slab_geometry(n: int, v: int):
    """A launch geometry whose tile rows track the slab length (D3's bug class)."""
    from repro_torch.kernels.fused_shuffle_reduce.fused_shuffle_reduce import LaunchGeometry

    tile = max(32, -(-(n // 4) // 32) * 32)             # BUG: length-derived tile
    return LaunchGeometry(tile_rows=tile, tiles=-(-n // tile))


def _mutant_slab_blocking(device="cpu"):
    return determinism.check_slab_invariance(_slab_geometry)


# --------------------------------------------------------------------------
# Plan mutants
# --------------------------------------------------------------------------


def _mutant_rank_duplicate(device="cpu"):
    from repro_torch.core.pipeline import WavePlan

    plan = WavePlan(
        rank_of_cluster=np.array([0, 1, 1, 3], np.int32),   # BUG: rank 1 twice
        chunk_of_cluster=np.array([0, 0, 1, 1], np.int32),
        num_chunks=2)
    return plan_checks.validate_wave_plan(plan, 4, "mutant-rank-duplicate")


def _mutant_chunk_out_of_range(device="cpu"):
    from repro_torch.core.pipeline import WavePlan

    plan = WavePlan(
        rank_of_cluster=np.arange(4, dtype=np.int32),
        chunk_of_cluster=np.array([0, 1, 2, 1], np.int32),  # BUG: chunk 2 of 2
        num_chunks=2)
    return plan_checks.validate_wave_plan(plan, 4, "mutant-chunk-range")


def _mutant_double_placed(device="cpu"):
    # BUG: cluster 2 rides in both waves, cluster 3 in none.
    return plan_checks.validate_membership([[0, 2], [1, 2]], 4, "mutant-double-placed")


def _mutant_dead_slot_loaded(device="cpu"):
    from repro_torch.core.scheduler import Schedule

    sched = Schedule(                       # BUG: slot 2 is dead but loaded
        assignment=np.array([0, 1, 2, 3, 2], np.int32),
        num_slots=4, slot_speeds=(1.0, 1.0, 0.0, 1.0))
    return plan_checks.validate_schedule(sched, "mutant-dead-slot")


def _real_snapshot():
    return tgt.plan_targets()[0][1]


def _mutant_chunk_cap_undersized(device="cpu"):
    snap = _real_snapshot()
    starved = dataclasses.replace(          # BUG: caps far below statistics
        snap, chunk_caps=tuple(1 for _ in snap.chunk_caps))
    return plan_checks.validate_snapshot(starved, "mutant-cap-undersized")


def _sketch_snapshot():
    for _name, snap in tgt.plan_targets():
        if snap.stats_provider == "sketch" and not snap.caps_estimated:
            return snap
    raise RuntimeError("no sketch plan target without estimated caps")


def _mutant_sketch_cap_undersized(device="cpu"):
    snap = _sketch_snapshot()
    starved = dataclasses.replace(          # BUG: caps below the estimates
        snap, chunk_caps=tuple(1 for _ in snap.chunk_caps))
    return plan_checks.validate_snapshot(starved, "mutant-sketch-cap")


def _mutant_sketch_unguarded(device="cpu"):
    snap = _sketch_snapshot()
    bare = dataclasses.replace(             # BUG: no guarantee, no hatch
        snap, stats_overestimate=False, caps_estimated=False)
    return plan_checks.validate_snapshot(bare, "mutant-sketch-unguarded")


def _mutant_lossy_snapshot(device="cpu"):
    from repro_torch.core.schedule_cache import CachedSchedule

    class _Lossy(CachedSchedule):
        def to_json(self):
            d = super().to_json()
            d.pop("slot_speeds")            # BUG: drops the Q||C_max speeds
            return d

    snap = _real_snapshot()
    lossy = _Lossy(**{f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)})
    return plan_checks.validate_roundtrip(lossy, "mutant-lossy-snapshot")


# --------------------------------------------------------------------------
# Source (AST) mutants
# --------------------------------------------------------------------------

_SRC_CAPTURE_TIME = """
    import time
    import torch

    @torch.compile
    def scaled(x):
        return x * time.time()      # BUG: capture-time clock
"""

_SRC_WIRE_SORT = """
    import torch

    def encode(slab):
        return slab[torch.argsort(slab[:, 0])]    # BUG: stability implicit
"""

_SRC_UNMARKED_SYNC = """
    import torch

    def peek(x):
        return x.sum().cpu()                     # BUG: no marker, not declared
"""


def _lint_snippet(relpath: str, source: str):
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / relpath
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))
        return conventions.lint_paths([path])


def _mutant_src_capture_time(device="cpu"):
    return _lint_snippet("serve/engine.py", _SRC_CAPTURE_TIME)


def _mutant_src_wire_sort(device="cpu"):
    return _lint_snippet("kernels/coded_shuffle/encode.py", _SRC_WIRE_SORT)


def _mutant_src_unmarked_sync(device="cpu"):
    return _lint_snippet("kernels/wave_timer/timers.py", _SRC_UNMARKED_SYNC)


# --------------------------------------------------------------------------
# Harness
# --------------------------------------------------------------------------

# The reference's catalog: (case, checker, rule, mutant). The one rule that
# differs is C1's, "jit-rng-time" in the reference, "capture-rng-time" here.
_CASES: Sequence = (
    ("a2a-dependency-chain", "overlap", "a2a-depends-on-a2a",
     _mutant_a2a_chain),
    ("stamp-pass-through-dropped", "overlap", "stamp-pass-through-dropped",
     _mutant_stamp_dropped),
    ("stamp-unanchored", "overlap", "stamp-unanchored",
     _mutant_stamp_unanchored),
    ("unstable-wire-sort", "determinism", "unstable-wire-sort",
     _mutant_unstable_sort),
    ("rogue-host-callback", "determinism", "undeclared-host-callback",
     _mutant_rogue_callback),
    ("slab-derived-blocking", "determinism", "slab-dependent-blocking",
     _mutant_slab_blocking),
    ("rank-duplicate", "plan", "rank-not-permutation",
     _mutant_rank_duplicate),
    ("chunk-out-of-range", "plan", "chunk-id-out-of-range",
     _mutant_chunk_out_of_range),
    ("cluster-double-placed", "plan", "cluster-not-placed-once",
     _mutant_double_placed),
    ("dead-slot-loaded", "plan", "dead-slot-loaded",
     _mutant_dead_slot_loaded),
    ("chunk-cap-undersized", "plan", "chunk-cap-undersized",
     _mutant_chunk_cap_undersized),
    ("sketch-cap-undersized", "plan", "chunk-cap-undersized",
     _mutant_sketch_cap_undersized),
    ("sketch-caps-unguarded", "plan", "sketch-caps-unguarded",
     _mutant_sketch_unguarded),
    ("lossy-snapshot", "plan", "snapshot-not-roundtrip",
     _mutant_lossy_snapshot),
    ("jitted-time-call", "conventions", "capture-rng-time",
     _mutant_src_capture_time),
    ("implicit-wire-sort", "conventions", "wire-sort-stability",
     _mutant_src_wire_sort),
    ("unmarked-callback", "conventions", "callback-marker",
     _mutant_src_unmarked_sync),
)


def run_self_tests(
        cases: Optional[Sequence] = None,
        progress: Callable[[str], None] = lambda _line: None,
        device="cpu",
) -> List[SelfTestResult]:
    """Run every mutation case (default: the catalog; its recorded mutants
    on ``device``); a case passes only with the intended checker + rule and
    non-empty evidence."""
    results: List[SelfTestResult] = []
    for name, checker, rule, fn in (_CASES if cases is None else cases):
        findings = fn(device=device)
        caught = any(
            f.checker == checker and f.rule == rule and len(f.evidence) > 0
            for f in findings)
        r = SelfTestResult(name, checker, rule, caught, list(findings))
        progress(r.render())
        results.append(r)
    return results


def self_tests_ok(results: Sequence[SelfTestResult]) -> bool:
    """True when every mutation was caught by its intended checker."""
    return all(r.caught for r in results)
