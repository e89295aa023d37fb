"""Host-sync allowlist, declared at the call site.

The determinism checker (:mod:`repro_torch.analysis.determinism`) flags
every host sync it finds in a recorded phase-B program — a ``.item()``, a
copy to the CPU, a ``nonzero``, a ``torch.cuda.synchronize`` or a host
clock stamp: each one stalls the card on the host and lets host state into
the program, so each must be *declared*, not discovered. Functions that
legitimately cross the host boundary register here::

    from repro_torch.analysis import allowlist

    @allowlist.allow_callback
    def _host_merge(self, outs): ...

and mark the syncing line with ``# analysis: allow-callback`` for the AST
convention lint (:mod:`repro_torch.analysis.conventions`, C3), so both
layers of the check read the declaration from the same place.

A second registry declares the float accumulates (``index_add_``,
``scatter_add_``, ``scatter_reduce_(..., "sum")``,
``index_put_(accumulate=True)``) that are exact by construction — sums of
integer values below 2^24, which no order of additions can change — so
the determinism checker's ``unordered-float-accumulate`` rule passes them::

    @allowlist.exact_accumulate
    def _segment_sum(data, seg, num_segments): ...

This module imports nothing, so kernel and core modules can register at
import time without pulling the analyzer in.
"""

from __future__ import annotations

from typing import Callable, FrozenSet, Set

# "module.qualname" of the functions that may make a host sync in a
# recorded program, and of those whose float accumulates are exact.
_ALLOWED: Set[str] = set()
_EXACT: Set[str] = set()


def qualname_of(fn: Callable) -> str:
    """The registry key of a function: ``module.qualname``."""
    return f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', repr(fn))}"


def allow_callback(fn: Callable) -> Callable:
    """Register ``fn`` as a function that may sync with the host (decorator)."""
    _ALLOWED.add(qualname_of(fn))
    return fn


def is_allowed(qualname: str) -> bool:
    """True when a host sync's resolved function was registered."""
    return qualname in _ALLOWED


def allowed_names() -> FrozenSet[str]:
    """Snapshot of the registered host-sync functions (for reports)."""
    return frozenset(_ALLOWED)


def exact_accumulate(fn: Callable) -> Callable:
    """Register ``fn``'s float accumulates as exact by construction (decorator)."""
    _EXACT.add(qualname_of(fn))
    return fn


def is_exact_accumulate(qualname: str) -> bool:
    """True when the function that made an accumulate declared it exact."""
    return qualname in _EXACT
