"""Public wrapper of the histogram kernel (OS4M local statistics, §4.1)."""

from __future__ import annotations

import torch

from repro_torch.kernels.histogram.histogram import histogram_cuda
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.kernels.pair_split import instance


# Launches of the CUDA kernel since import (or since a caller reset it):
# +1 per launch, never for the plain version on the CPU; and the same split
# by instance (``pair_split.instance``).
launches = 0
launches_by_instance = {"mask": 0, "float": 0}


def histogram(ids: torch.Tensor, weights: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Per-slot weighted histogram, the ``K^(i)`` rows of paper eq. 4-1.

    ``ids (m, K)`` int32 and ``weights (m, K)`` give ``(m, num_bins)``
    float32: ``out[i, b] = sum_t weights[i, t] * (ids[i, t] == b)``, ids
    outside ``[0, num_bins)`` dropped. CPU tensors run the plain version;
    CUDA tensors launch ``csrc/histogram.cu`` (one launch for all slots,
    counted in this module's ``launches``) or raise. The weights' dtype
    picks the kernel's instance (``pair_split.instance``):

    * ``torch.bool``, the ``mask`` instance: a pair counts 1 where its
      weight is True. Integer counters; equal to the plain version bit for
      bit wherever a bin holds at most ``2^24`` pairs. Above that float32
      cannot hold every integer and the plain version's float sums stall,
      so the two may differ: a documented limit, not a fault (the engine's
      bins hold at most ``K = 2^21`` pairs a slot).
    * ``torch.float32``, the ``float`` instance: general weights, float
      atomics in a varying order, allclose to the plain version.
    """
    kind = instance(weights.dtype)
    if ids.device.type == "cpu":
        return histogram_ref(ids, weights, num_bins)
    if ids.device.type != "cuda" or weights.device != ids.device:
        raise ValueError(
            f"histogram needs ids and weights on one CUDA device (or the CPU),"
            f" got {ids.device} and {weights.device}")
    if ids.dim() != 2 or weights.shape != ids.shape:
        raise ValueError(
            f"histogram needs (m, K) ids and weights of one shape, got"
            f" {tuple(ids.shape)} and {tuple(weights.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"histogram needs int32 ids, got {ids.dtype}")
    if not (ids.is_contiguous() and weights.is_contiguous()):
        raise ValueError("histogram needs contiguous ids and weights")
    m, k = ids.shape
    if not 1 <= m <= 65535 or not 1 <= num_bins < 2 ** 31:
        raise ValueError(f"histogram supports 1..65535 slots and 1..2^31-1 bins,"
                         f" got m={m}, num_bins={num_bins}")
    out = torch.zeros((m, num_bins), dtype=torch.float32, device=ids.device)
    if k == 0:
        return out
    with torch.cuda.device(ids.device):
        histogram_cuda(ids, weights, out, kind)
    global launches
    launches += 1
    launches_by_instance[kind] += 1
    return out

