"""Public wrapper of the count-min sketch kernel (compressed statistics)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.pair_split import instance
from repro_torch.kernels.sketch_hist.ref import sketch_hist_ref
from repro_torch.kernels.sketch_hist.sketch_hist import sketch_hist_cuda

# Launches of the CUDA kernel since import (or since a caller reset it):
# +1 per launch, never for the plain version on the CPU; and the same split
# by instance (``pair_split.instance``).
launches = 0
launches_by_instance = {"mask": 0, "float": 0}

MAX_DEPTH = 16  # hash rows the kernel takes by value


def sketch_hist(ids: torch.Tensor, weights: torch.Tensor, multipliers,
                width: int) -> torch.Tensor:
    """Weighted count-min counters of every slot: ``(m, depth, width)`` float32.

    ``out[i, r, b] = sum_t weights[i, t] * (h_r(ids[i, t]) == b)`` with
    ``h_r(x) = (a_r * x mod 2^32) >> (32 - log2 width)`` over the ids'
    uint32 bit patterns. ``ids (m, K)`` int32; ``weights (m, K)``
    ``torch.bool`` (the ``mask`` instance: integer counters, equal to the
    plain version bit for bit wherever a cell holds at most ``2^24`` pairs;
    above that the plain version's float32 sums stall, a documented limit)
    or ``torch.float32`` (the ``float`` instance: allclose);
    ``multipliers`` are the ``depth`` host integers ``a_r`` in ``[0,
    2^32)`` (a numpy array or a sequence); ``width`` is a power of two >=
    2. Row ``i`` equals the reference's ``sketch_hist_pallas(ids[i],
    weights[i], multipliers, width)``. CPU tensors run the plain version;
    CUDA tensors launch ``csrc/sketch_hist.cu`` (one launch for all slots
    and rows, counted in this module's ``launches``) or raise.
    """
    width = int(width)
    if width < 2 or width & (width - 1) or width > 2 ** 30:
        raise ValueError(f"width must be a power of two in [2, 2^30], got {width}")
    mult = np.asarray([int(a) for a in np.asarray(multipliers).reshape(-1)], np.int64)
    if mult.size == 0 or mult.size > MAX_DEPTH or (mult < 0).any() \
            or (mult >= 2 ** 32).any():
        raise ValueError(
            f"sketch_hist needs 1..{MAX_DEPTH} multipliers in [0, 2^32),"
            f" got {mult.tolist()}")
    kind = instance(weights.dtype)
    if ids.device.type == "cpu":
        return sketch_hist_ref(ids, weights, mult, width)
    if ids.device.type != "cuda" or weights.device != ids.device:
        raise ValueError(
            f"sketch_hist needs ids and weights on one CUDA device (or the CPU),"
            f" got {ids.device} and {weights.device}")
    if ids.dim() != 2 or weights.shape != ids.shape:
        raise ValueError(
            f"sketch_hist needs (m, K) ids and weights of one shape, got"
            f" {tuple(ids.shape)} and {tuple(weights.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"sketch_hist needs int32 ids, got {ids.dtype}")
    if not (ids.is_contiguous() and weights.is_contiguous()):
        raise ValueError("sketch_hist needs contiguous ids and weights")
    m, k = ids.shape
    if not 1 <= m <= 65535:
        raise ValueError(f"sketch_hist supports 1..65535 slots, got m={m}")
    out = torch.zeros((m, mult.size, width), dtype=torch.float32, device=ids.device)
    if k == 0:
        return out
    with torch.cuda.device(ids.device):
        sketch_hist_cuda(ids, weights, mult.astype(np.uint32), out, kind)
    global launches
    launches += 1
    launches_by_instance[kind] += 1
    return out
