"""ctypes binding of ``csrc/moe_dispatch.cu`` (built at first use), and a
numpy model of the kernel's decomposition.

The kernel is one pass with decoupled look-back: each CTA ranks one tile
of :data:`TILE_TOKENS` tokens, publishes the tile's per-destination
aggregate and then its inclusive prefix as descriptor words tagged with
the call's epoch, and finds its own exclusive prefix by reading windows of
:func:`lookback_rows` predecessor tiles. Its scratch (a ticket and the
descriptors) is kept per (device, stream): zeroed once when allocated,
then reused by every call on that stream with a new epoch, so a call
zeroes nothing, and two streams never share a buffer.
:func:`dispatch_ranks_model` and :func:`lookback` repeat the kernel's
arithmetic in numpy for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_DESTS = 1024
TILE_TOKENS = 8192   # tokens a CTA (kTile)
WARPS = 32           # warps a CTA, each owning TILE_TOKENS / WARPS tokens
LOOK_LOADS = 8       # descriptor words a thread reads a look-back window
EPOCHS = 2 ** 32 - 1  # epochs 1..EPOCHS, then the scratch is zeroed again

# (device index, stream handle) -> [scratch (int64), last epoch used on it].
# Two calls must never get one epoch on one buffer: the lock makes the
# lookup and the bump one step for threads that share a stream.
_scratch: Dict[Tuple[int, int], List] = {}
_scratch_lock = threading.Lock()


@functools.cache
def _lib():
    lib = _build.load("moe_dispatch")
    lib.dispatch_ranks_i32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_uint, ctypes.c_void_p]
    lib.dispatch_ranks_i32.restype = ctypes.c_int
    lib.dispatch_ranks_scratch_words.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.dispatch_ranks_scratch_words.restype = ctypes.c_longlong
    return lib


def _stream_scratch(device: torch.device, stream: int, words: int) -> Tuple[torch.Tensor, int]:
    """The scratch of ``stream`` (at least ``words`` int64 words) and the
    epoch of this call. Calls on one stream run in order, so they may share
    one buffer; a new or larger buffer starts zeroed at epoch 1."""
    key = (device.index, stream)
    with _scratch_lock:
        entry = _scratch.get(key)
        if entry is None or entry[0].numel() < words:
            entry = [torch.zeros(words, dtype=torch.int64, device=device), 0]
            _scratch[key] = entry
        if entry[1] == EPOCHS:
            entry[0].zero_()
            entry[1] = 0
        entry[1] += 1
        return entry[0], entry[1]


def dispatch_ranks_cuda(dest: torch.Tensor, rank: torch.Tensor, counts: torch.Tensor,
                        num_dests: int) -> None:
    """Launch the kernel: fills ``rank (T,)`` and ``counts (E,)``.

    Shapes, types, device and contiguity are the caller's to check
    (``ops.dispatch_ranks``). Raises if the launch is refused, or under
    CUDA graph capture (a replay would reuse the captured epoch).
    """
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("dispatch_ranks cannot be captured in a CUDA graph: each call "
                           "needs a new epoch")
    lib = _lib()
    n = dest.shape[0]
    stream = torch.cuda.current_stream(dest.device).cuda_stream
    scratch, epoch = _stream_scratch(dest.device, stream,
                                     lib.dispatch_ranks_scratch_words(n, num_dests))
    rc = lib.dispatch_ranks_i32(dest.data_ptr(), rank.data_ptr(), counts.data_ptr(),
                                scratch.data_ptr(), n, num_dests, epoch, stream)
    if rc != 0:
        raise RuntimeError(f"moe_dispatch kernel launch failed: cudaError {rc}")


def lookback_rows(num_dests: int) -> int:
    """Predecessor tiles one look-back window reads (the kernel's
    ``lookback_rows``): ``WARPS * 32 * LOOK_LOADS`` words over E, at least 1."""
    return max(1, WARPS * 32 * LOOK_LOADS // num_dests)


def lookback(tile: int, prefix_ready: np.ndarray, aggregates: np.ndarray,
             window: int) -> Tuple[np.ndarray, int]:
    """The kernel's look-back of tile ``tile`` over a snapshot of the
    descriptors. ``prefix_ready[b, e]`` says whether tile ``b`` had
    published its inclusive prefix for destination ``e`` (else its
    aggregate) when it was read; ``aggregates (tiles, E)``. Tile 0 always
    has. Returns the tile's exclusive prefix ``(E,)`` and the windows read.
    """
    inclusive = np.cumsum(aggregates, axis=0)
    num_dests = aggregates.shape[1]
    found = np.zeros(num_dests, np.int64)
    closed = np.zeros(num_dests, bool)
    windows = 0
    top = tile - 1
    while not closed.all():
        windows += 1
        rows = np.arange(top, max(top - window + 1, 0) - 1, -1)
        for e in np.flatnonzero(~closed):
            ready = [r for r in rows if r == 0 or prefix_ready[r, e]]
            stop = max(ready) if ready else -1
            for r in rows[rows >= stop]:
                found[e] += inclusive[r, e] if r == stop else aggregates[r, e]
            closed[e] = stop >= 0
        top -= window
    return found, windows


def dispatch_ranks_model(dest: np.ndarray, num_dests: int, tile_tokens: int = TILE_TOKENS,
                         warps: int = WARPS, prefix_ready=None) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's ranks and counts, computed as the kernel decomposes them:
    per tile and warp (``tile_tokens / warps`` tokens, 32 at a time) a local
    rank from the warp's running count plus the lower lanes with the same
    destination; the warps' counts scanned into offsets and the tile's
    aggregate; the tile's prefix from :func:`lookback` over the snapshot
    ``prefix_ready`` (None: every predecessor had published its prefix)."""
    dest = np.asarray(dest, np.int64)
    n = dest.shape[0]
    per_warp = tile_tokens // warps
    tiles = -(-n // tile_tokens)
    valid = (dest >= 0) & (dest < num_dests)
    local = np.full(n, -1, np.int64)
    offsets = np.zeros((tiles, warps, num_dests), np.int64)
    aggregates = np.zeros((tiles, num_dests), np.int64)
    for b in range(tiles):
        for w in range(warps):
            run = np.zeros(num_dests, np.int64)
            lo = b * tile_tokens + w * per_warp
            for g in range(lo, min(lo + per_warp, n), 32):
                d = dest[g:min(g + 32, n, lo + per_warp)]
                ok = valid[g:g + len(d)]
                for j in np.flatnonzero(ok):
                    local[g + j] = run[d[j]] + np.sum(ok[:j] & (d[:j] == d[j]))
                np.add.at(run, d[ok], 1)
            offsets[b, w] = aggregates[b]
            aggregates[b] += run
    if prefix_ready is None:
        prefix_ready = np.ones((tiles, num_dests), bool)
    window = lookback_rows(num_dests)
    rank = np.full(n, -1, np.int64)
    for b in range(tiles):
        prefix = lookback(b, prefix_ready, aggregates, window)[0] if b else aggregates[0] * 0
        t = np.arange(b * tile_tokens, min((b + 1) * tile_tokens, n))
        t = t[valid[t]]
        w = (t - b * tile_tokens) // per_warp
        d = dest[t]
        rank[t] = prefix[d] + offsets[b, w, d] + local[t]
    counts = aggregates.sum(axis=0)
    return rank.astype(np.int32), counts.astype(np.int32)
