"""ctypes binding of ``csrc/histogram.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _entry():
    fn = _build.load("histogram").histogram_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def histogram_cuda(ids: torch.Tensor, weights: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel: ``out (m, n)`` f32, zeroed, += histogram of ``ids``.

    Shapes, types, device and contiguity are the caller's to check
    (``ops.histogram``). Raises if the launch is refused.
    """
    m, k = ids.shape
    rc = _entry()(ids.data_ptr(), weights.data_ptr(), out.data_ptr(), m, k,
                  out.shape[1], torch.cuda.current_stream(ids.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed: cudaError {rc}")
