"""Host-side contract checks of the port (``python -m repro_torch.analysis``).

The reference's analyzer has four checkers; the port carries the two that
read host objects and source text, with the reference's exit-code bits:

* ``plan``         — structural invariants of ``WavePlan`` / ``Schedule``
  / ``CachedSchedule`` (:mod:`repro_torch.analysis.plan_checks`), run on
  the real planner's outputs (:mod:`repro_torch.analysis.targets`).
* ``conventions``  — AST lint over ``src/repro_torch``: no Python clock or
  RNG in a function that is captured once and replayed, explicit sort
  stability on the wire (:mod:`repro_torch.analysis.conventions`).

The reference's ``overlap`` and ``determinism`` checkers read jaxprs; their
torch counterparts, and the mutation self-tests, are not ported yet.
"""

from __future__ import annotations

__all__ = ["main", "run"]


def __getattr__(name):
    """Lazy re-exports, so importing a checker does not load the CLI."""
    if name in ("main", "run"):
        from repro_torch.analysis import __main__ as cli
        return getattr(cli, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
