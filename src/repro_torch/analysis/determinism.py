"""Determinism linter: declared host syncs, stable wires, ordered sums,
fixed blocking.

The reference's three rules (``repro.analysis.determinism``) over the
recorded phase-B graphs (:mod:`repro_torch.analysis.op_graph`), and one
rule of the port's own:

**undeclared-host-callback (D1)** — a host sync (``.item()``, a copy to
the CPU, ``nonzero``, ``torch.cuda.synchronize``) or a host clock stamp
lets host state into a device program and stalls the card, so each must
resolve to a function registered in :mod:`repro_torch.analysis.allowlist`.

**unstable-wire-sort (D2)** — the coded shuffle's decode works only
because sender and receiver run the *identical* sort over replicated
records, and ties are common. Any ``sort`` node with ``stable`` false
(torch's default) that is entangled with the wire — an ``all_to_all``
among its ancestors or its consumers — makes the wire permutation
dependent. In a coded target every sort counts.

**unordered-float-accumulate (D2 on CUDA)** — ``index_add_``,
``scatter_add_``, ``scatter_reduce_(..., "sum")`` and
``index_put_(accumulate=True)`` on a float tensor add in whatever order
the card's atomics land, just as an unstable sort orders ties, and so
break the same bit-equality contract. The rule fires where such a node
is connected to the wire or feeds the primary outputs (0 and 1), unless
the function that made it declared its sums exact
(:func:`~repro_torch.analysis.allowlist.exact_accumulate`: integer values
below 2^24). Accumulates inside a kernel node are the kernel's own
fixed-order sums and are not seen.

**slab-dependent-blocking (D3)** — a bug class the engine has shipped:
blocking derived from the data-dependent slab length changes the
reduction tree, so the same records sum to different floats depending on
how full the slab is.
The fused kernel's launch geometry is a pure function of the launch
(:func:`repro_torch.kernels.fused_shuffle_reduce.fused_shuffle_reduce.launch_geometry`);
:func:`check_slab_invariance` lays out the tiles it gives at slab
lengths 96 and 160, and 3,000 and 5,000 (across a 2,048-row tile edge),
over rows that share their leading segments, and requires every shared
segment's tiles, taken relative to its first row, to be identical.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.analysis import allowlist
from repro_torch.analysis.op_graph import OpGraph
from repro_torch.analysis.report import Finding

# Slab-length pairs that share their leading rows: two inside one tile, and
# two on either side of the first tile edge.
SLAB_PAIRS = ((96, 160), (3000, 5000))
# Segment lengths laid out from row 0 (the last segment runs to the end).
_SEGMENTS = {96: (7, 20, 33, 1, 15), 3000: (500, 2100, 300, 64)}


def check_determinism(targets: Sequence, extra_allowed: Sequence[str] = (),
                      geometry: Optional[Callable] = None) -> List[Finding]:
    """Run D1, D2 and its CUDA form over every recorded target, then D3 on
    the fused kernel's launch geometry."""
    findings: List[Finding] = []
    for t in targets:
        findings.extend(_check_callbacks(t.name, t.graph, extra_allowed))
        findings.extend(_check_wire_sorts(t.name, t.graph, coded=t.coded))
        findings.extend(_check_accumulates(t.name, t.graph))
    findings.extend(check_slab_invariance(geometry))
    return findings


def _check_callbacks(name: str, g: OpGraph, extra_allowed: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for n in g.nodes:
        qual = n.attrs.get("callback")
        if qual is None or allowlist.is_allowed(qual) or qual in extra_allowed:
            continue
        findings.append(Finding(
            checker="determinism",
            rule="undeclared-host-callback",
            target=name,
            summary=(
                f"host sync in {qual!r}, which is not in the analyzer "
                "allowlist — undeclared host effects (clocks, values read "
                "back) break the replayability of a device program"),
            evidence=[n.describe(),
                      f"allowed: {sorted(allowlist.allowed_names()) or 'none'}"],
        ))
    return findings


def _wire_chain(g: OpGraph, nid: int, a2a_ids) -> List[int]:
    """A chain linking ``nid`` to the wire ([] when it is not linked)."""
    up = g.ancestors_of(nid) & a2a_ids
    if up:
        return g.find_path(min(up), nid)
    down = g.reachable_from([nid]) & a2a_ids
    if down:
        return g.find_path(nid, min(down))
    return []


def _check_wire_sorts(name: str, g: OpGraph, coded: bool) -> List[Finding]:
    findings: List[Finding] = []
    a2a_ids = {n.id for n in g.by_prim("all_to_all")}
    for n in g.by_prim("sort"):
        if n.attrs.get("is_stable", True):
            continue
        chain = _wire_chain(g, n.id, a2a_ids)
        if not (coded or chain):
            continue
        findings.append(Finding(
            checker="determinism",
            rule="unstable-wire-sort",
            target=name,
            summary=(
                "an unstable sort is entangled with the shuffle wire — ties "
                "reorder freely, so sender and receiver can rebuild "
                "different slabs (identical-sort contract broken)"),
            evidence=g.describe_path(chain or [n.id]),
        ))
    return findings


def _check_accumulates(name: str, g: OpGraph) -> List[Finding]:
    findings: List[Finding] = []
    a2a_ids = {n.id for n in g.by_prim("all_to_all")}
    primary = g.output_producer_ids([0, 1])
    for n in g.nodes:
        if not n.attrs.get("float_accumulate") or allowlist.is_exact_accumulate(n.site):
            continue
        chain = _wire_chain(g, n.id, a2a_ids)
        if not chain:
            hit = primary & (g.reachable_from([n.id]) | {n.id})
            chain = g.find_path(n.id, min(hit)) if hit else []
        if not chain:
            continue
        findings.append(Finding(
            checker="determinism",
            rule="unordered-float-accumulate",
            target=name,
            summary=(
                f"a float {n.prim} outside a kernel feeds the wire or the "
                "outputs — on CUDA its additions land in any order, so the "
                "same records can sum to different bits"),
            evidence=g.describe_path(chain) + [
                f"made by {n.site}; declare it with allowlist.exact_accumulate only "
                "if every sum is an integer below 2^24"],
        ))
    return findings


def _segment_rows(length: int) -> np.ndarray:
    """Sorted segment ids of a slab of ``length`` rows whose leading
    segments are those of the shorter length of its pair."""
    lens = next(v for k, v in _SEGMENTS.items()
                if any(k in pair and length in pair for pair in SLAB_PAIRS))
    seg = np.empty(length, np.int64)
    row = 0
    for s, n in enumerate(lens):
        seg[row:min(row + n, length)] = s
        row += n
        if row >= length:
            return seg
    seg[row:] = len(lens)
    return seg


def segment_tiles(seg: np.ndarray, num_segments: int, tile_rows: int) -> dict:
    """``segment -> ((start, end), ...)`` of its tiles, relative to the
    segment's first row, as the fused kernel cuts them at ``tile_rows``."""
    from repro_torch.kernels.fused_shuffle_reduce.fused_shuffle_reduce import tile_plan

    first = np.searchsorted(seg, np.arange(num_segments), side="left")
    out: dict = {}
    for _block, _which, s, start, end in tile_plan(seg, num_segments, tile_rows):
        out.setdefault(s, []).append((start - int(first[s]), end - int(first[s])))
    return {s: tuple(sorted(t)) for s, t in out.items()}


def check_slab_invariance(geometry: Optional[Callable] = None) -> List[Finding]:
    """D3: the fused kernel's tiles must not depend on the slab length.

    ``geometry(n, v)`` is the launch geometry of an ``n``-row slab of
    ``v``-wide values (default: the kernel's own ``launch_geometry``, the
    function its launch calls); its ``tile_rows`` cut each segment. At each
    pair of lengths, the segments complete in both slabs must have the same
    tiles relative to their first row.
    """
    if geometry is None:
        from repro_torch.kernels.fused_shuffle_reduce.fused_shuffle_reduce import (
            launch_geometry as geometry,
        )
    findings: List[Finding] = []
    for short, long in SLAB_PAIRS:
        seg_s, seg_l = _segment_rows(short), _segment_rows(long)
        num = int(seg_l.max()) + 1
        done = [s for s in range(num) if (seg_s == s).sum() == (seg_l == s).sum() > 0
                and short > np.flatnonzero(seg_s == s)[-1] + 1]
        tiles_s = segment_tiles(seg_s, num, geometry(short, 3).tile_rows)
        tiles_l = segment_tiles(seg_l, num, geometry(long, 3).tile_rows)
        differ = [s for s in done if tiles_s.get(s) != tiles_l.get(s)]
        if not differ:
            continue
        findings.append(Finding(
            checker="determinism",
            rule="slab-dependent-blocking",
            target="fused_shuffle_reduce",
            summary=(
                "the fused kernel's tiles change with the slab length — "
                "blocking derives from the data-dependent length, so a "
                "segment's reduction tree (and its float rounding) varies "
                "per slab"),
            evidence=[f"slab length {short}: tile rows {geometry(short, 3).tile_rows}, "
                      f"segment {s} tiles {tiles_s.get(s)}" for s in differ[:3]]
            + [f"slab length {long}: tile rows {geometry(long, 3).tile_rows}, "
               f"segment {s} tiles {tiles_l.get(s)}" for s in differ[:3]],
        ))
    return findings


def runtime_slab_invariance(device) -> List[Finding]:
    """D3 at run time: kernel 2 (``fused_shuffle_reduce``) on real-valued
    float32 rows at each pair of :data:`SLAB_PAIRS` — the longer slab's
    leading rows are the shorter one — must give every segment complete in
    both the same sums bit for bit. On CUDA tensors this launches the
    kernel; on the CPU it checks the plain version."""
    import torch

    from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops

    findings: List[Finding] = []
    rng = np.random.default_rng(0)
    for short, long in SLAB_PAIRS:
        seg_l = _segment_rows(long)
        num = int(seg_l.max()) + 1
        vals = torch.from_numpy(rng.standard_normal((1, long, 3)).astype(np.float32))
        vals = vals.to(device)
        sums = []
        for n in (short, long):
            seg = torch.from_numpy(_segment_rows(n).astype(np.int32)).to(device)[None]
            idx = torch.arange(n, dtype=torch.int32, device=device)[None]
            out, _ = fused_ops.fused_shuffle_reduce(vals[:, :n].contiguous(), idx, seg, num)
            sums.append(out[0].cpu())
        seg_s = seg_l[:short]
        done = [s for s in range(num) if (seg_s == s).sum() == (seg_l == s).sum() > 0
                and short > np.flatnonzero(seg_s == s)[-1] + 1]
        differ = [s for s in done if not torch.equal(sums[0][s], sums[1][s])]
        if differ or not done:
            findings.append(Finding(
                checker="determinism",
                rule="slab-dependent-blocking",
                target="fused_shuffle_reduce",
                summary=(f"kernel 2's sums of segments shared by slabs of {short} and "
                         f"{long} rows differ bit for bit"),
                evidence=[f"segment {s}: {sums[0][s].tolist()} vs {sums[1][s].tolist()}"
                          for s in differ[:3]] or ["no segment complete in both slabs"],
            ))
    return findings
