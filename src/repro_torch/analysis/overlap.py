"""Overlap certifier: the §4.4 copy/run contract + honest wave stamps.

The reference's two rules (``repro.analysis.overlap``), over each
recorded phase-B graph (:mod:`repro_torch.analysis.op_graph`):

**a2a-depends-on-a2a** — the pipelined engine's whole speedup is that the
"copy" of chunk ``c+1`` is in flight while the "run" of chunk ``c``
computes. On the card that holds iff the copy can be issued without
waiting for anything the reduce of chunk ``c`` produces, i.e. iff no
``all_to_all`` node transitively consumes another's output: every reduce
of chunk ``c`` depends on chunk ``c``'s copy, so a ``reduce(c) →
copy(c+1)`` edge shows up as exactly such a path. (This also covers the
coded wire: the packets are built from the sender's own spill, never from
the replica exchange's output.) On violation the finding's evidence is
the offending dependency chain, one op per line.

**stamp-unanchored / stamp-pass-through-dropped** — a wave-timer stamp
(kernel 6, ``stamp_through``) is only honest if true buffer dependencies
pin it on both sides: (a) it has an ``all_to_all`` among its ancestors —
it cannot fire before its wave's data exists — and (b) its pass-through
output (slot 0) is on a path to the program's primary outputs (the
reduced values and counts, outputs 0 and 1), so the reduce after it read
the copy the stamp made rather than the original buffer.
"""

from __future__ import annotations

from typing import List, Sequence

from repro_torch.analysis.op_graph import OpGraph
from repro_torch.analysis.report import Finding

_STAMP_PRIMS = ("stamp",)


def check_overlap(targets: Sequence) -> List[Finding]:
    """Run both overlap rules over every recorded target."""
    findings: List[Finding] = []
    for t in targets:
        findings.extend(_check_a2a_independence(t.name, t.graph))
        if t.timed:
            findings.extend(_check_stamps(t.name, t.graph))
    return findings


def _check_a2a_independence(name: str, g: OpGraph) -> List[Finding]:
    findings: List[Finding] = []
    a2a_ids = [n.id for n in g.by_prim("all_to_all")]
    a2a_set = set(a2a_ids)
    for src in a2a_ids:
        hit = g.reachable_from([src]) & a2a_set
        if not hit:
            continue
        chain = g.find_path(src, min(hit))
        findings.append(Finding(
            checker="overlap",
            rule="a2a-depends-on-a2a",
            target=name,
            summary=(
                "an all_to_all transitively consumes another all_to_all's "
                "output — the next chunk's copy is serialized behind this "
                "chunk's pipeline (§4.4 overlap broken)"),
            evidence=g.describe_path(chain),
        ))
    return findings


def _check_stamps(name: str, g: OpGraph) -> List[Finding]:
    findings: List[Finding] = []
    a2a_ids = {n.id for n in g.by_prim("all_to_all")}
    # Primary outputs = the reduce values + counts (slots 0 and 1); the
    # ticks output must NOT be what keeps a stamp alive.
    primary = g.output_producer_ids([0, 1])
    for s in (n for n in g.nodes if n.prim in _STAMP_PRIMS):
        if not (g.ancestors_of(s.id) & a2a_ids):
            findings.append(Finding(
                checker="overlap",
                rule="stamp-unanchored",
                target=name,
                summary=(
                    "a wave-timer stamp has no all_to_all among its "
                    "ancestors — it can fire before its wave's data exists"),
                evidence=[s.describe(), "ancestor set contains no all_to_all node"],
            ))
        direct = any(out is not None and out == (s.id, 0)
                     for out in (g.outputs[i] for i in (0, 1) if i < len(g.outputs)))
        consumers = g.consumers_of_output(s.id, 0)
        reach = set(consumers) | g.reachable_from(list(consumers))
        if not direct and not (reach & primary):
            findings.append(Finding(
                checker="overlap",
                rule="stamp-pass-through-dropped",
                target=name,
                summary=(
                    "a wave-timer stamp's pass-through output never reaches "
                    "the primary outputs — downstream compute read the "
                    "original buffer, so nothing orders the stamp before the "
                    "wave it should precede"),
                evidence=[s.describe(),
                          "pass-through consumers: "
                          f"{[g.nodes[c].describe() for c in sorted(consumers)] or 'none'}",
                          "none of them reach output 0/1 producers"],
            ))
    return findings
