"""Contract checks of the port (``python -m repro_torch.analysis``).

The reference's four checkers, with its exit-code bits, over the port's
recorded programs, host objects and source text:

* ``overlap``      — §4.4 copy/run overlap: no all-to-all depends on
  another all-to-all's output, and every wave-timer stamp is pinned by
  true buffer dependencies (:mod:`repro_torch.analysis.overlap`).
* ``determinism``  — host syncs only from the declared allowlist, no
  unstable sort and no unordered float accumulate on the wire, and
  slab-length-invariant kernel tiles (:mod:`repro_torch.analysis.determinism`).
* ``plan``         — structural invariants of ``WavePlan`` / ``Schedule``
  / ``CachedSchedule`` (:mod:`repro_torch.analysis.plan_checks`), run on
  the real planner's outputs.
* ``conventions``  — AST lint over ``src/repro_torch``: no Python clock or
  RNG in a function that is captured once and replayed, explicit sort
  stability on the wire, declared host syncs in phase B
  (:mod:`repro_torch.analysis.conventions`).

The first two read recorded runs of the engine's phase-B bodies
(:mod:`repro_torch.analysis.op_graph`, :mod:`repro_torch.analysis.targets`)
where the reference reads jaxprs. Each checker is proven by the mutation
self-tests (:mod:`repro_torch.analysis.mutations`, ``--self-test``): seeded
violations the analyzer must catch with the right checker, rule and a
non-empty evidence path.

This ``__init__`` stays import-light: :mod:`repro_torch.analysis.allowlist`
is imported by core and kernel modules at import time, and must not drag
the analyzer along.
"""

from __future__ import annotations

__all__ = ["main", "run"]


def __getattr__(name):
    """Lazy re-exports, so importing a checker does not load the CLI."""
    if name in ("main", "run"):
        from repro_torch.analysis import __main__ as cli
        return getattr(cli, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
