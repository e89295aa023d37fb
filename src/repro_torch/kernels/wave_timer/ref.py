"""Plain versions of the wave-timer kernels, and the tick word format.

A *tick stamp* is a pair of ``uint32`` words ``(lo, hi)`` holding one
64-bit monotone counter sample — the reference's format, which every
consumer reads through :func:`combine_ticks` without caring which clock
produced the words. The plain tick source is the host's
``time.perf_counter_ns`` (monotone, ns resolution); the CUDA kernels
substitute the device's ``%globaltimer`` and keep the word format.

The plain versions are what the ops run on CPU tensors: a stamp is the
host clock at the moment of the call, which on the CPU is after every
anchor was computed (CPU tensor operations are synchronous).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.analysis import allowlist

__all__ = ["read_ticks_ref", "split_ticks", "combine_ticks", "stamp_through_ref"]

_WORD = np.uint64(0xFFFFFFFF)
_SHIFT = np.uint64(32)


def read_ticks_ref() -> np.ndarray:
    """One host tick stamp: ``perf_counter_ns`` split into (lo, hi) words."""
    return split_ticks(time.perf_counter_ns())


def split_ticks(ticks) -> np.ndarray:
    """Split 64-bit counter value(s) into trailing ``(..., 2)`` uint32 words."""
    t = np.asarray(ticks, np.uint64)
    return np.stack([t & _WORD, t >> _SHIFT], axis=-1).astype(np.uint32)


def combine_ticks(words) -> np.ndarray:
    """Recombine ``(..., 2)`` uint32 (lo, hi) words into int64 counter values.

    Inverse of :func:`split_ticks`. int64 (not uint64) so downstream
    arithmetic — tick *differences* — is ordinary signed math;
    ``perf_counter_ns`` and ``%globaltimer`` values fit comfortably.
    """
    w = np.asarray(words, np.uint64)
    if w.shape[-1] != 2:
        raise ValueError(f"expected trailing (lo, hi) word axis, got {w.shape}")
    return ((w[..., 0] | (w[..., 1] << _SHIFT))).astype(np.int64)


@allowlist.allow_callback
def read_ticks_plain() -> torch.Tensor:
    """The plain ``read_ticks``: one host stamp as a ``(2,)`` uint32 tensor."""
    return torch.from_numpy(read_ticks_ref())


@allowlist.allow_callback
def stamp_through_ref(primary: torch.Tensor):
    """The plain ``stamp_through``: ``(primary.clone(), host stamp)``."""
    return primary.clone(), read_ticks_plain()
