"""ctypes binding of ``csrc/fused_shuffle_reduce.cu`` (built at first use),
and a Python mirror of the kernel's tile plan.

The kernel cuts each segment's rows into tiles of :data:`TILE_ROWS` rows
anchored at the segment's first row and hands each tile to the position
block ``[b T, (b + 1) T)`` of its slot that holds the tile's first row.
:func:`launch_geometry` is the launch's geometry, a pure function that the
launch itself calls (and the determinism checker reads, D3);
:func:`tile_plan` lists the tiles as the kernel walks them; the tests
hold it to covering every valid row exactly once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

# Rows a tile: a multiple of the warp's 32 lanes (each lane adds 64 rows).
TILE_ROWS = 2048


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """Rows a tile, and position blocks (tiles) a slot, of one launch."""

    tile_rows: int
    tiles: int


def launch_geometry(n: int, v: int) -> LaunchGeometry:
    """The geometry of a launch over ``n`` rows of ``v``-wide values.

    The tile is fixed: a segment's tiles, anchored at its first row, are
    then the same whatever the slab's length, and so are its sums' bits.
    """
    del v
    return LaunchGeometry(tile_rows=TILE_ROWS, tiles=-(-n // TILE_ROWS))


@functools.cache
def _entry():
    fn = _build.load("fused_shuffle_reduce").fused_gather_segment_sum_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_gather_segment_reduce_cuda(
    values: torch.Tensor, gather_idx: torch.Tensor, seg_ids: torch.Tensor,
    out: torch.Tensor, counts: torch.Tensor,
) -> None:
    """Launch the kernels: fill ``out (m, S, V)`` with the segment sums and
    ``counts (m, S)`` with the segments' row counts (both float32).

    Shapes, types, device and contiguity are the caller's to check
    (``ops.fused_shuffle_reduce``). Raises if a launch is refused.
    """
    m, n, v = values.shape
    num_segments = out.shape[1]
    dev = values.device
    geo = launch_geometry(n, v)
    starts = torch.empty((m, num_segments + 1), dtype=torch.int64, device=dev)
    arrivals = torch.empty((m, num_segments), dtype=torch.int32, device=dev)
    partials = torch.empty((m, geo.tiles, 2, v), dtype=torch.float32, device=dev)
    rc = _entry()(values.data_ptr(), gather_idx.data_ptr(), seg_ids.data_ptr(),
                  out.data_ptr(), counts.data_ptr(), starts.data_ptr(), arrivals.data_ptr(),
                  partials.data_ptr(), m, n, v, num_segments, geo.tile_rows,
                  torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused shuffle-reduce kernel launch failed: cudaError {rc}")


def tile_plan(seg: np.ndarray, num_segments: int,
              tile_rows: int = TILE_ROWS) -> List[Tuple[int, int, int, int, int]]:
    """The tiles of one slot's sorted ``seg`` row, in the kernel's order.

    Returns ``(block, which, segment, start, end)`` per tile: rows ``[start,
    end)`` of ``segment``, run by position block ``block``; ``which`` is 0
    for the segment that holds the block's first row, else 1 (the
    workspace slot of a multi-tile segment's partial).
    """
    seg = np.asarray(seg)
    n = seg.shape[0]
    starts = np.searchsorted(seg, np.arange(num_segments + 1), side="left")
    tiles = []
    for b in range(-(-n // tile_rows)):
        row0, row_end = b * tile_rows, min((b + 1) * tile_rows, n)
        s = int(seg[row0])
        if s >= num_segments or seg[row_end - 1] < 0:
            continue
        if s < 0:
            s = int(seg[row0 + np.searchsorted(seg[row0:row_end], 0, side="left")])
            if s >= num_segments:
                continue
        while True:
            lo, hi = int(starts[s]), int(starts[s + 1])
            if lo <= row0:
                start = lo + -(-(row0 - lo) // tile_rows) * tile_rows
                if start < hi:
                    tiles.append((b, 0, s, start, min(start + tile_rows, hi)))
            else:
                tiles.append((b, 1, s, lo, min(lo + tile_rows, hi)))
            if hi >= row_end:
                break
            s = int(seg[hi])
            if s >= num_segments:
                break
    return tiles
