"""ctypes binding of ``csrc/fused_shuffle_reduce.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _entry():
    fn = _build.load("fused_shuffle_reduce").fused_gather_segment_sum_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_gather_segment_reduce_cuda(
    values: torch.Tensor, gather_idx: torch.Tensor, seg_ids: torch.Tensor,
    out: torch.Tensor,
) -> None:
    """Launch the kernel: fills ``out (m, S, V)`` f32 with the segment sums.

    Shapes, types, device and contiguity are the caller's to check
    (``ops.fused_shuffle_reduce``). Raises if the launch is refused.
    """
    m, n, v = values.shape
    rc = _entry()(values.data_ptr(), gather_idx.data_ptr(), seg_ids.data_ptr(),
                  out.data_ptr(), m, n, v, out.shape[1],
                  torch.cuda.current_stream(values.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused shuffle-reduce kernel launch failed: cudaError {rc}")
