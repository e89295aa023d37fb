"""ctypes binding of ``csrc/xor_words.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _entries():
    lib = _build.load("xor_words")
    flat, encode = lib.xor_words_i32, lib.xor_encode_packets_i32
    flat.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_void_p]
    encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    flat.restype = encode.restype = ctypes.c_int
    return flat, encode


def xor_words_cuda(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the flat instance: ``out = a ^ b`` over the tensors' words.

    Shapes, types, device and contiguity are the caller's to check
    (``ops.xor_words``). Raises if the launch is refused.
    """
    rc = _entries()[0](a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                       torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"xor_words kernel launch failed: cudaError {rc}")


def encode_packets_cuda(slab: torch.Tensor, out: torch.Tensor, first_sender: int) -> None:
    """Launch the encode instance over an ``(R, m, m, ...)`` word slab of
    senders ``first_sender .. first_sender + R - 1`` into ``out`` of its
    shape (every word written).

    Shapes, types, device and contiguity are the caller's to check
    (``ops.encode_packets``). Raises if the launch is refused.
    """
    senders, m = slab.shape[0], slab.shape[1]
    rc = _entries()[1](slab.data_ptr(), out.data_ptr(), senders, m, first_sender,
                       slab.numel() // (senders * m * m),
                       torch.cuda.current_stream(slab.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"xor_words encode kernel launch failed: cudaError {rc}")
