"""Public wrapper of the histogram kernel (OS4M local statistics, §4.1)."""

from __future__ import annotations

import torch

from repro_torch.kernels.histogram.histogram import histogram_cuda
from repro_torch.kernels.histogram.ref import histogram_ref


# Launches of the CUDA kernel since import (or since a caller reset it):
# +1 per launch, never for the plain version on the CPU.
launches = 0


def histogram(ids: torch.Tensor, weights: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Per-slot weighted histogram, the ``K^(i)`` rows of paper eq. 4-1.

    ``ids (m, K)`` int32 and ``weights (m, K)`` float32 give ``(m,
    num_bins)`` float32: ``out[i, b] = sum_t weights[i, t] * (ids[i, t] ==
    b)``, ids outside ``[0, num_bins)`` dropped. CPU tensors run the plain
    version; CUDA tensors launch ``csrc/histogram.cu`` (one launch for all
    slots, counted in this module's ``launches``) or raise.
    """
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
    if ids.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(
            f"histogram needs int32 ids and float32 weights, got {ids.dtype}"
            f" and {weights.dtype}")
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
        histogram_cuda(ids, weights, out)
    global launches
    launches += 1
    return out

