"""Roofline terms of one step on one H100 (the reference's
``repro.launch.hlo_analysis`` ``HW`` / ``RooflineTerms`` / ``roofline_terms``).

The reference reads FLOPs, HBM bytes and collective bytes from XLA's
optimized HLO text; the port has no compiled program to parse. Its
dry-run (:mod:`repro_torch.launch.dryrun`) counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` and bytes from the ``meta``
tensors every op reads and writes, and hands them here. On one card no
collective runs, so ``collective_bytes`` is 0.

The constants are the H100 SXM's spec-sheet values (dense bf16 tensor-core
peak, HBM3 bandwidth and capacity), not the reference's TPU constants.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    """One H100 SXM, spec sheet."""

    peak_flops: float = 989.4e12     # bf16 dense FLOP/s
    hbm_bw: float = 3.35e12          # B/s
    hbm_bytes: float = 80e9          # device memory
    link_bw: float = 450e9           # NVLink B/s a direction (unused on one card)


@dataclasses.dataclass
class RooflineTerms:
    """Compute, memory and collective times of one step, and their bound."""

    flops: float
    hbm_bytes: float
    collective_bytes: float = 0.0
    chips: int = 1
    hw: HW = dataclasses.field(default_factory=HW)

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap lower bound: the largest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "step_time_lower_bound_s": self.step_time,
        }


def roofline_terms(flops: float, hbm_bytes: float) -> RooflineTerms:
    """The terms of a step that does ``flops`` and moves ``hbm_bytes`` on
    one card (no collective bytes)."""
    return RooflineTerms(flops=float(flops), hbm_bytes=float(hbm_bytes))
