"""ctypes binding of ``csrc/histogram.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pair_split import split_phase


@functools.cache
def _entries():
    lib = _build.load("histogram")
    entries = {"mask": lib.histogram_mask, "float": lib.histogram_f32}
    for fn in entries.values():
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return entries


def histogram_cuda(ids: torch.Tensor, weights: torch.Tensor, out: torch.Tensor,
                   instance: str) -> None:
    """Launch the kernel's ``instance`` (``"mask"``: bool weights,
    ``"float"``: float32): ``out (m, n)`` f32, zeroed, += histogram of ``ids``.

    Shapes, types, device and contiguity are the caller's to check
    (``ops.histogram``). Raises if the launch is refused.
    """
    m, k = ids.shape
    phase = split_phase(ids.data_ptr(), weights.data_ptr(), weights.element_size())
    rc = _entries()[instance](ids.data_ptr(), weights.data_ptr(), out.data_ptr(), m, k,
                              out.shape[1], phase,
                              torch.cuda.current_stream(ids.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"histogram kernel ({instance}) launch failed: cudaError {rc}")
