"""ctypes binding of ``csrc/segment_reduce.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _entry():
    fn = _build.load("segment_reduce").segment_reduce_sorted_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_reduce_sorted_cuda(values: torch.Tensor, seg_ids: torch.Tensor,
                               out: torch.Tensor) -> None:
    """Launch the kernel: fills ``out (m, S, V)`` f32 with the segment sums.

    Shapes, types, device and contiguity are the caller's to check
    (``ops.segment_reduce_sorted``). Raises if the launch is refused.
    """
    m, n, v = values.shape
    rc = _entry()(values.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), m, n, v,
                  out.shape[1], torch.cuda.current_stream(values.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_reduce kernel launch failed: cudaError {rc}")
