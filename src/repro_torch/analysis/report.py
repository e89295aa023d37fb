"""Findings, reports, and the per-checker exit-code contract.

Every checker returns a list of :class:`Finding`; the CLI merges them
into a :class:`Report` whose exit code is a *bitmask* with one bit per
checker, so a red run names its checker(s) from the status alone. The
bits are the reference analyzer's::

    overlap      -> 1
    determinism  -> 2
    plan         -> 4
    conventions  -> 8
    (self-test failure adds 16)

A finding always carries non-empty ``evidence`` — for the recorded-program
checkers the offending dependency chain, one op per line, for plan
checkers the violated invariant with the concrete values, for the AST
lint the file:line source excerpt.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

CHECKERS = ("overlap", "determinism", "plan", "conventions")

# Exit-code bit per checker (CLI contract, see module docstring).
CHECKER_BITS: Dict[str, int] = {
    "overlap": 1,
    "determinism": 2,
    "plan": 4,
    "conventions": 8,
}
SELF_TEST_BIT = 16


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation: which checker, which rule, where, and why."""

    checker: str          # one of CHECKERS
    rule: str             # short rule id, e.g. "dead-slot-loaded"
    target: str           # plan / file the rule ran on
    summary: str          # one-line human statement of the violation
    evidence: Sequence[str] = ()   # readable path/excerpt, one step per line

    def __post_init__(self):
        if self.checker not in CHECKER_BITS:
            raise ValueError(f"unknown checker {self.checker!r}")

    def render(self) -> str:
        """Multi-line human form: header + indented evidence chain."""
        head = f"[{self.checker}:{self.rule}] {self.target}: {self.summary}"
        if not self.evidence:
            return head
        return head + "\n" + "\n".join(f"    {line}" for line in self.evidence)


@dataclasses.dataclass
class Report:
    """All findings of one analyzer run + which checkers actually ran."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    checkers_run: List[str] = dataclasses.field(default_factory=list)

    def extend(self, checker: str, findings: Sequence[Finding]) -> None:
        """Record one checker's results (registers it as run)."""
        if checker not in self.checkers_run:
            self.checkers_run.append(checker)
        self.findings.extend(findings)

    @property
    def ok(self) -> bool:
        """True when no checker that ran produced a finding."""
        return not self.findings

    def exit_code(self) -> int:
        """OR of the failing checkers' bits (0 = everything passed)."""
        code = 0
        for f in self.findings:
            code |= CHECKER_BITS[f.checker]
        return code

    def render(self) -> str:
        """The full human report: per-checker verdicts, then findings."""
        lines = []
        failed = {f.checker for f in self.findings}
        for c in self.checkers_run:
            lines.append(f"{c:12s} {'FAIL' if c in failed else 'ok'}")
        for f in self.findings:
            lines.append(f.render())
        return "\n".join(lines)
