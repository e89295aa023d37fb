"""ctypes binding of ``csrc/wave_timer.cu`` (built at first use)."""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels import _build

MAX_ANCHORS = 8
BULK_ALIGN = 16   # bytes: address and size granule of a bulk copy


def copy_split(src_ptr: int, dst_ptr: int, nbytes: int) -> tuple:
    """``(head, body)`` of a copy of ``nbytes`` from ``src_ptr`` to ``dst_ptr``.

    Bytes ``[head, head + body)`` go by bulk copies: both addresses are
    16-byte aligned there and ``body`` is a multiple of 16. The head
    ``[0, head)`` and the tail ``[head + body, nbytes)``, each under 16
    bytes, go by threads. Where the two addresses disagree mod 16 no byte
    can go in bulk: ``(0, 0)``, the byte path.
    """
    if (src_ptr - dst_ptr) % BULK_ALIGN:
        return 0, 0
    head = min(nbytes, -src_ptr % BULK_ALIGN)
    return head, (nbytes - head) // BULK_ALIGN * BULK_ALIGN


@functools.cache
def _entries():
    lib = _build.load("wave_timer")
    read = lib.wave_timer_read_ticks
    read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    read.restype = ctypes.c_int
    stamp = lib.wave_timer_stamp_through
    stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    stamp.restype = ctypes.c_int
    ring = lib.wave_timer_stamp_through_ring
    ring.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p]
    ring.restype = ctypes.c_int
    floor = lib.wave_timer_launch_floor
    floor.argtypes = [ctypes.c_void_p]
    floor.restype = ctypes.c_int
    return read, stamp, ring, floor


def _anchor_array(anchors: Sequence[torch.Tensor]):
    ptrs = (ctypes.c_void_p * max(1, len(anchors)))(*[a.data_ptr() for a in anchors])
    return ptrs, len(anchors)


def read_ticks_cuda(anchors: Sequence[torch.Tensor], ticks: torch.Tensor) -> None:
    """Launch the stamp kernel into ``ticks`` ((2,) uint32) on the current stream.

    Devices, types and anchor sizes are the caller's to check
    (``ops.read_ticks``). Raises if the launch is refused.
    """
    ptrs, count = _anchor_array(anchors)
    rc = _entries()[0](ptrs, count, ticks.data_ptr(),
                       torch.cuda.current_stream(ticks.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"read_ticks kernel launch failed: cudaError {rc}")


def launch_floor_cuda(device: torch.device) -> None:
    """Launch an empty kernel on ``device``'s current stream: the launch
    floor that bounds :func:`read_ticks_cuda` (not counted as a launch of
    kernel 5). Raises if the launch is refused."""
    rc = _entries()[3](torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {rc}")


def stamp_through_cuda(primary: torch.Tensor, out: torch.Tensor,
                       anchors: Sequence[torch.Tensor], ticks: torch.Tensor) -> None:
    """Launch the copy + stamp kernel: ``out`` = ``primary`` byte for byte.

    Both are contiguous tensors of one size on one device (checked by
    ``ops.stamp_through``). The bulk-copy ring takes the copy when
    :func:`copy_split` leaves it a body, the byte path otherwise. Raises if
    the launch is refused.
    """
    ptrs, count = _anchor_array(anchors)
    nbytes = primary.numel() * primary.element_size()
    stream = torch.cuda.current_stream(ticks.device).cuda_stream
    src, dst = primary.data_ptr(), out.data_ptr()
    head, body = copy_split(src, dst, nbytes)
    if body > 0:
        rc = _entries()[2](src, dst, nbytes, head, body, ptrs, count, ticks.data_ptr(), stream)
    else:
        rc = _entries()[1](src, dst, nbytes, ptrs, count, ticks.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"stamp_through kernel launch failed: cudaError {rc}")
