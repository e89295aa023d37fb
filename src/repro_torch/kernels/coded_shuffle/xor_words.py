"""ctypes binding of ``csrc/xor_words.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _entry():
    fn = _build.load("xor_words").xor_words_i32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def xor_words_cuda(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel: ``out = a ^ b`` over the tensors' words.

    Shapes, types, device and contiguity are the caller's to check
    (``ops.xor_words``). Raises if the launch is refused.
    """
    rc = _entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                  torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"xor_words kernel launch failed: cudaError {rc}")
