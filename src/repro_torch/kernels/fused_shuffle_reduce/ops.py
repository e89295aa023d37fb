"""Public wrapper of the fused shuffle->reduce kernel.

``fused_shuffle_reduce`` is the Reduce "sort" + "run" of one pipeline
chunk for every slot at once: gather each slot's received pairs through
the schedule's sort order and segment-sum them per operation cluster,
and count each cluster's pairs on the way.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.fused_shuffle_reduce.fused_shuffle_reduce import (
    fused_gather_segment_reduce_cuda,
)
from repro_torch.kernels.fused_shuffle_reduce.ref import (
    fused_gather_segment_reduce_ref,
)


# Launches of the CUDA kernel since import (or since a caller reset it):
# +1 per call (its two kernels, segment_starts and reduce_tiles), never for
# the plain version on the CPU.
launches = 0


def fused_shuffle_reduce(
    values: torch.Tensor,      # (m, N, V) unsorted value table per slot
    gather_idx: torch.Tensor,  # (m, N) int32 sort order into ``values``
    seg_ids: torch.Tensor,     # (m, N) int32 segment per sorted stream row
    num_segments: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather-by-order + sorted segment-sum, fused. Returns ``(out (m, S, V),
    counts (m, S))``, both float32: the sums and the rows of each segment.

    ``seg_ids`` must be non-decreasing along each row; ids outside ``[0,
    num_segments)`` are padding. CPU tensors run the plain version; CUDA
    tensors launch ``csrc/fused_shuffle_reduce.cu`` (one call for all
    slots, counted once in this module's ``launches``) or raise.
    """
    if values.device.type == "cpu":
        return fused_gather_segment_reduce_ref(values, gather_idx, seg_ids, num_segments)
    if values.device.type != "cuda" or {gather_idx.device, seg_ids.device} != {values.device}:
        raise ValueError(
            "fused_shuffle_reduce needs all inputs on one CUDA device (or the"
            f" CPU), got {values.device}, {gather_idx.device}, {seg_ids.device}")
    if values.dim() != 3 or gather_idx.shape != values.shape[:2] \
            or seg_ids.shape != values.shape[:2]:
        raise ValueError(
            "fused_shuffle_reduce needs (m, N, V) values and (m, N) indices,"
            f" got {tuple(values.shape)}, {tuple(gather_idx.shape)},"
            f" {tuple(seg_ids.shape)}")
    if values.dtype != torch.float32 or gather_idx.dtype != torch.int32 \
            or seg_ids.dtype != torch.int32:
        raise TypeError(
            "fused_shuffle_reduce needs float32 values and int32 indices, got"
            f" {values.dtype}, {gather_idx.dtype}, {seg_ids.dtype}")
    if not (values.is_contiguous() and gather_idx.is_contiguous()
            and seg_ids.is_contiguous()):
        raise ValueError("fused_shuffle_reduce needs contiguous inputs")
    m, n, v = values.shape
    if not 1 <= m <= 65535 or not 1 <= num_segments < 2 ** 31:
        raise ValueError(
            f"fused_shuffle_reduce supports 1..65535 slots and 1..2^31-1"
            f" segments, got m={m}, num_segments={num_segments}")
    out = torch.empty((m, num_segments, v), dtype=torch.float32, device=values.device)
    counts = torch.empty((m, num_segments), dtype=torch.float32, device=values.device)
    if n == 0:
        return out.zero_(), counts.zero_()
    with torch.cuda.device(values.device):
        fused_gather_segment_reduce_cuda(values, gather_idx, seg_ids, out, counts)
    global launches
    launches += 1
    return out, counts

