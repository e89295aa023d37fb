"""What the histogram and sketch kernels share on the host (``csrc/pair_count.cuh``).

Both count ``(id, weight)`` pairs into cells and come in two instances,
chosen by the weights' dtype (:func:`instance`). Both read each row as a
scalar head, a body of 16-byte loads and a scalar tail; the kernel takes
the pointers' phase from :func:`split_phase` and splits every row as
:func:`row_split` does.
"""

from __future__ import annotations

import torch

__all__ = ["PAIRS_A_LOAD", "instance", "row_split", "split_phase"]

PAIRS_A_LOAD = 4  # pairs of one int4 of ids


def instance(dtype: torch.dtype) -> str:
    """The kernel instance for weights of ``dtype``: ``torch.bool`` ->
    ``"mask"`` (a 0/1 mask, integer counters), ``torch.float32`` ->
    ``"float"``; any other dtype raises ``TypeError``."""
    if dtype == torch.bool:
        return "mask"
    if dtype == torch.float32:
        return "float"
    raise TypeError(f"weights must be torch.bool (a 0/1 mask) or torch.float32, got {dtype}")


def split_phase(ids_ptr: int, w_ptr: int, w_itemsize: int) -> int:
    """The pairs' element phase mod 4, shared by the int32 ids at
    ``ids_ptr`` and the weights (``w_itemsize`` bytes each) at ``w_ptr``;
    -1 where the two disagree, so that no pair starts a 16-byte load of ids
    and a 4-pair load of weights at once (every pair is then read alone).

    Pair ``g`` (counted over all rows) starts both loads exactly when
    ``(phase + g) % 4 == 0``.
    """
    if ids_ptr % 4 or w_ptr % w_itemsize:
        return -1
    p_ids = ids_ptr // 4 % PAIRS_A_LOAD
    p_w = w_ptr // w_itemsize % PAIRS_A_LOAD
    return p_ids if p_ids == p_w else -1


def row_split(phase: int, k: int, row: int) -> tuple:
    """``(head, units)`` of row ``row`` of ``k`` pairs: pairs ``[0, head)``
    and ``[head + 4 units, k)`` are read one at a time, ``[head, head + 4
    units)`` as ``units`` 4-pair loads, each aligned for ids and weights.
    With ``phase == -1`` there is no body: ``(0, 0)``."""
    if phase < 0:
        return 0, 0
    head = min(k, -(phase + row * k) % PAIRS_A_LOAD)
    return head, (k - head) // PAIRS_A_LOAD
