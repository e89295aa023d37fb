"""ctypes binding of ``csrc/moe_dispatch.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_DESTS = 1024


@functools.cache
def _lib():
    lib = _build.load("moe_dispatch")
    lib.dispatch_ranks_i32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.dispatch_ranks_i32.restype = ctypes.c_int
    lib.dispatch_ranks_scratch_words.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.dispatch_ranks_scratch_words.restype = ctypes.c_longlong
    return lib


def dispatch_ranks_cuda(dest: torch.Tensor, rank: torch.Tensor, counts: torch.Tensor,
                        num_dests: int) -> None:
    """Launch the kernel's three passes: fills ``rank (T,)`` and ``counts (E,)``.

    Shapes, types, device and contiguity are the caller's to check
    (``ops.dispatch_ranks``). Raises if a launch is refused.
    """
    lib = _lib()
    n = dest.shape[0]
    words = lib.dispatch_ranks_scratch_words(n, num_dests)
    scratch = torch.empty(words, dtype=torch.int32, device=dest.device)
    rc = lib.dispatch_ranks_i32(dest.data_ptr(), rank.data_ptr(), counts.data_ptr(),
                                scratch.data_ptr(), n, num_dests,
                                torch.cuda.current_stream(dest.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_dispatch kernel launch failed: cudaError {rc}")
