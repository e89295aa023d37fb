"""CLI: ``python -m repro_torch.analysis [--check plan|conventions|all]``.

Exit code is the checker bitmask from :mod:`repro_torch.analysis.report`
(plan 4, conventions 8 — the reference analyzer's bits), so a red run
names the failing layer from the status alone.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

from repro_torch.analysis.report import CHECKERS, Report


def run(check: str = "all", out=None) -> int:
    """Run the selected checker(s) on the port's real targets.

    Returns the bitmask exit code; prints the human report to ``out``
    (current ``sys.stdout`` when None — resolved per call, not at import).
    """
    from repro_torch.analysis import conventions, plan_checks
    from repro_torch.analysis import targets as tgt

    if out is None:
        out = sys.stdout
    if check != "all" and check not in CHECKERS:
        raise ValueError(f"unknown checker {check!r}; use one of "
                         f"{('all',) + CHECKERS}")
    selected = CHECKERS if check == "all" else (check,)
    t0 = time.perf_counter()
    report = Report()
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
    print(report.render(), file=out)
    print(f"exit code {code} ({time.perf_counter() - t0:.1f}s)", file=out)
    return code


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Argparse entry point (see module docstring for the exit contract)."""
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Check the plan invariants and source conventions of the "
                    "port's OS4M engine.")
    parser.add_argument("--check", default="all",
                        choices=("all",) + CHECKERS,
                        help="which checker to run (default: all)")
    ns = parser.parse_args(argv)
    sys.exit(run(check=ns.check))


if __name__ == "__main__":
    main()
