"""Public wrapper of the sorted segment-sum kernel (Reduce "run" phase).

No engine path calls it, as in the reference, whose engine passes
``use_kernel=False`` at both ``_segment_reduce`` call sites: phase B's
sum goes through the fused gather + segment-sum kernel instead. It is
the port of the reference's ``segment_reduce_sorted`` entry point.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce.ref import segment_reduce_sorted_ref
from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_sorted_cuda

# Launches of the CUDA kernel since import (or since a caller reset it):
# +1 per call (its two kernels, segment_starts and reduce_tiles), never for
# the plain version on the CPU.
launches = 0


def segment_reduce_sorted(values: torch.Tensor, seg_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Segment sum over rows already sorted by ``seg_ids``: (m, S, V) float32.

    ``values (m, N, V)`` float32 and ``seg_ids (m, N)`` int32,
    non-decreasing along each row (the kernel relies on it; the plain
    version does not); ids outside ``[0, num_segments)`` are dropped. Row
    ``i`` equals the reference's ``segment_reduce_sorted(values[i],
    seg_ids[i], num_segments)``. CPU tensors run the plain version; CUDA
    tensors launch ``csrc/segment_reduce.cu`` (one call for all slots,
    counted once in this module's ``launches``) or raise.
    """
    if values.device.type == "cpu":
        return segment_reduce_sorted_ref(values, seg_ids, num_segments)
    if values.device.type != "cuda" or seg_ids.device != values.device:
        raise ValueError(
            "segment_reduce_sorted needs values and ids on one CUDA device (or"
            f" the CPU), got {values.device} and {seg_ids.device}")
    if values.dim() != 3 or seg_ids.shape != values.shape[:2]:
        raise ValueError(
            "segment_reduce_sorted needs (m, N, V) values and (m, N) ids, got"
            f" {tuple(values.shape)} and {tuple(seg_ids.shape)}")
    if values.dtype != torch.float32 or seg_ids.dtype != torch.int32:
        raise TypeError(
            "segment_reduce_sorted needs float32 values and int32 ids, got"
            f" {values.dtype} and {seg_ids.dtype}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_reduce_sorted needs contiguous inputs")
    m, n, v = values.shape
    if not 1 <= m <= 65535 or not 1 <= num_segments < 2 ** 31 - 1:
        raise ValueError(
            f"segment_reduce_sorted supports 1..65535 slots and 1..2^31-2"
            f" segments, got m={m}, num_segments={num_segments}")
    if n == 0 or v == 0:
        return torch.zeros((m, num_segments, v), dtype=torch.float32,
                           device=values.device)
    out = torch.empty((m, num_segments, v), dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        segment_reduce_sorted_cuda(values, seg_ids, out)
    global launches
    launches += 1
    return out
