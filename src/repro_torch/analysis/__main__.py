"""CLI: ``python -m repro_torch.analysis [--check all|<checker>] [--self-test]``.

Exit code is the checker bitmask from :mod:`repro_torch.analysis.report`
(overlap 1, determinism 2, plan 4, conventions 8; a mutation self-test
failure adds 16 — the reference analyzer's bits), so a red run names the
failing layer from the status alone. The phase-B programs are recorded on
the CPU (``chip_smoke.py`` records them on the card).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

from repro_torch.analysis.report import CHECKERS, SELF_TEST_BIT, Report


def run(check: str = "all", self_test: bool = False, out=None) -> int:
    """Run the selected checker(s) on the port's real targets.

    Returns the bitmask exit code; prints the human report to ``out``
    (current ``sys.stdout`` when None — resolved per call, not at import).
    """
    from repro_torch.analysis import conventions, determinism, overlap, plan_checks
    from repro_torch.analysis import targets as tgt

    if out is None:
        out = sys.stdout
    if check != "all" and check not in CHECKERS:
        raise ValueError(f"unknown checker {check!r}; use one of "
                         f"{('all',) + CHECKERS}")
    selected = CHECKERS if check == "all" else (check,)
    t0 = time.perf_counter()
    report = Report()
    recorded = None
    if "overlap" in selected or "determinism" in selected:
        recorded = tgt.phase_b_targets()
        print(f"recorded {len(recorded)} phase-B variants: "
              f"{', '.join(t.name for t in recorded)}", file=out)
    if "overlap" in selected:
        report.extend("overlap", overlap.check_overlap(recorded))
    if "determinism" in selected:
        report.extend("determinism", determinism.check_determinism(recorded))
    if "plan" in selected:
        plans = tgt.plan_targets()
        print(f"validated {len(plans)} planner snapshots: "
              f"{', '.join(name for name, _ in plans)}", file=out)
        report.extend("plan", plan_checks.check_plans(plans))
    if "conventions" in selected:
        root = conventions.default_root()
        report.extend("conventions", conventions.lint_tree(root))
        print(f"linted package tree at {root}", file=out)
    code = report.exit_code()
    if self_test:
        from repro_torch.analysis import mutations

        results = mutations.run_self_tests(
            progress=lambda line: print(f"self-test {line}", file=out))
        caught = sum(r.caught for r in results)
        print(f"self-test {caught}/{len(results)} caught", file=out)
        if not mutations.self_tests_ok(results):
            code |= SELF_TEST_BIT
    print(report.render(), file=out)
    print(f"exit code {code} ({time.perf_counter() - t0:.1f}s)", file=out)
    return code


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Argparse entry point (see module docstring for the exit contract)."""
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Check the overlap, determinism and plan invariants and the "
                    "source conventions of the port's OS4M engine.")
    parser.add_argument("--check", default="all",
                        choices=("all",) + CHECKERS,
                        help="which checker to run (default: all)")
    parser.add_argument("--self-test", action="store_true",
                        help="also run the mutation self-tests (each seeded "
                             "violation must be caught)")
    ns = parser.parse_args(argv)
    sys.exit(run(check=ns.check, self_test=ns.self_test))


if __name__ == "__main__":
    main()
