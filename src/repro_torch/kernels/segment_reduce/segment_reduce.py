"""ctypes binding of ``csrc/segment_reduce.cu`` (built at first use).

The kernel cuts each segment's rows into the fused reduce's tiles
(``fused_shuffle_reduce.TILE_ROWS`` rows anchored at the segment's first
row, as ``fused_shuffle_reduce.tile_plan`` lists them) and adds them in
the fused reduce's order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_shuffle_reduce.fused_shuffle_reduce import TILE_ROWS


@functools.cache
def _entry():
    fn = _build.load("segment_reduce").segment_reduce_sorted_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_reduce_sorted_cuda(values: torch.Tensor, seg_ids: torch.Tensor,
                               out: torch.Tensor) -> None:
    """Launch the kernels: fills ``out (m, S, V)`` f32 with the segment sums.

    Shapes, types, device and contiguity are the caller's to check
    (``ops.segment_reduce_sorted``). Raises if a launch is refused.
    """
    m, n, v = values.shape
    num_segments = out.shape[1]
    dev = values.device
    starts = torch.empty((m, num_segments + 1), dtype=torch.int64, device=dev)
    arrivals = torch.empty((m, num_segments), dtype=torch.int32, device=dev)
    partials = torch.empty((m, -(-n // TILE_ROWS), 2, v), dtype=torch.float32, device=dev)
    rc = _entry()(values.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), starts.data_ptr(),
                  arrivals.data_ptr(), partials.data_ptr(), m, n, v, num_segments, TILE_ROWS,
                  torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_reduce kernel launch failed: cudaError {rc}")
