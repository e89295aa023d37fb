"""ctypes binding of ``csrc/sketch_hist.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pair_split import split_phase


@functools.cache
def _entries():
    lib = _build.load("sketch_hist")
    entries = {"mask": lib.sketch_hist_mask, "float": lib.sketch_hist_f32}
    for fn in entries.values():
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return entries


def sketch_hist_cuda(ids: torch.Tensor, weights: torch.Tensor, multipliers: np.ndarray,
                     out: torch.Tensor, instance: str) -> None:
    """Launch the kernel's ``instance`` (``"mask"``: bool weights,
    ``"float"``: float32): ``out (m, depth, width)`` f32, zeroed, += the sketch.

    ``multipliers`` is a host ``(depth,)`` uint32 array. Shapes, types,
    device and contiguity are the caller's to check (``ops.sketch_hist``).
    Raises if the launch is refused.
    """
    m, k = ids.shape
    mult = np.ascontiguousarray(multipliers, dtype=np.uint32)
    phase = split_phase(ids.data_ptr(), weights.data_ptr(), weights.element_size())
    rc = _entries()[instance](ids.data_ptr(), weights.data_ptr(), out.data_ptr(), m, k,
                              mult.ctypes.data, mult.shape[0], out.shape[2], phase,
                              torch.cuda.current_stream(ids.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sketch_hist kernel ({instance}) launch failed: cudaError {rc}")
