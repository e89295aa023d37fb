"""Public wave-timer ops: per-slot clock stamps on the slot's stream, and their unit.

Two ops, one per ordering the measured executor needs:

* ``stamp_through(primary, *anchors)`` → ``(copy, ticks)`` — the op the
  executor brackets waves with: a bit-identical copy of ``primary`` and
  one clock stamp, taken in one kernel launched on the current (the
  slot's) stream. The stream orders it after everything the slot enqueued
  before (the previous wave's reduce) and before everything it enqueues
  after (the next wave's reduce, which reads the copy). Consecutive waves
  share their boundary stamp (end(c) ≡ start(c+1)), so the copy's few
  microseconds are billed to the wave after the boundary.
* ``read_ticks(*anchors)`` → ``(2,)`` uint32 (lo, hi) stamp — the
  anchor-only flavour, for calibration and telemetry.

``anchors`` are tensors whose computation must precede the stamp. On the
stream that is already so; an anchor produced on *another* stream is
named through ``streams=``, and the current stream waits on each of them
before the launch.

Backend resolution, by where the tensors live:

* ``"device"`` — CUDA tensors: the kernels of ``csrc/wave_timer.cu``
  (``%globaltimer``), calibrated once per process and device. A failed
  build or launch raises; it never drops to another backend.
* ``"host"`` — CPU tensors: ``perf_counter_ns`` at the call, exactly
  1e-9 s a tick (the reference's ``"callback"`` path). CPU tensor
  operations are synchronous, so the call happens after its anchors.
* ``"none"`` — only through :class:`force_backend`: no tick source, so
  :func:`available` is False and the measured executor takes its
  host-fenced fallback (:func:`repro_torch.core.mesh_timing.
  shard_ready_seconds`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import allowlist
from repro_torch.device import default_device
from repro_torch.kernels.wave_timer import calibration as _cal
from repro_torch.kernels.wave_timer import ref as wt_ref
from repro_torch.kernels.wave_timer.wave_timer import (
    MAX_ANCHORS,
    read_ticks_cuda,
    stamp_through_cuda,
)

__all__ = ["backend", "available", "read_ticks", "stamp_through", "combine_ticks",
           "tick_calibration", "force_backend", "ticks_numpy"]

# Launches of each CUDA kernel since import (or since a caller reset them):
# +1 per launch, never for the plain versions on the CPU.
read_ticks_launches = 0
stamp_through_launches = 0

# force_backend("none") drills the host-fenced fallback without removing
# the tick source.
_FORCED: Optional[str] = None
_BACKENDS = ("device", "host", "none")

combine_ticks = wt_ref.combine_ticks


def _device_of(where) -> torch.device:
    """The device of ``where`` (a tensor or a device); ``None`` is the
    current CUDA device, and raises where there is none: the host stamps
    are for CPU tensors, which a caller names (``"cpu"``)."""
    if isinstance(where, torch.Tensor):
        return where.device
    return default_device(where, "the wave timer")


def backend(where=None) -> str:
    """The tick backend for tensors on ``where`` (a tensor or a device):
    ``"device"`` for CUDA, ``"host"`` for the CPU, unless forced. ``None``
    means the current CUDA device, and raises where there is none."""
    if _FORCED is not None:
        return _FORCED
    return "device" if _device_of(where).type == "cuda" else "host"


def available(where=None) -> bool:
    """True when stamps can be read for tensors on ``where``."""
    return backend(where) != "none"


def _prepare(device: torch.device, anchors, streams) -> list:
    """Checked anchors for a launch on ``device`` (empty ones carry no data
    and are dropped); the current stream waits on every producer stream."""
    if len(anchors) > MAX_ANCHORS:
        raise ValueError(f"at most {MAX_ANCHORS} anchors, got {len(anchors)}")
    kept = []
    for a in anchors:
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"anchors must be tensors, got {type(a).__name__}")
        if a.device != device:
            raise ValueError(f"anchor on {a.device}, stamp on {device}")
        if a.numel() > 0:
            kept.append(a)
    if streams:
        current = torch.cuda.current_stream(device)
        for s in streams:
            if s != current:
                current.wait_stream(s)
    return kept


def read_ticks(*anchors: torch.Tensor, device=None, streams: Sequence = ()) -> torch.Tensor:
    """One clock stamp ``(2,)`` uint32, taken after ``anchors``.

    The stamp lives where the tensors do: on the CUDA ``device`` (default:
    the first anchor's, else the current CUDA device) it is launched on the
    current stream; on the CPU (``device="cpu"`` or CPU anchors) it is the
    host clock now. With no device, no anchor and no CUDA it raises.
    """
    dev = _device_of(device if device is not None else (anchors[0] if anchors else None))
    b = backend(dev)
    if b == "host":
        return wt_ref.read_ticks_plain()
    if b == "none":
        raise RuntimeError("no wave-timer tick backend (forced 'none')")
    if dev.type != "cuda":
        raise ValueError(f"the device tick source needs a CUDA device, got {dev}")
    with torch.cuda.device(dev):
        kept = _prepare(dev, anchors, streams)
        ticks = torch.empty(2, dtype=torch.uint32, device=dev)
        read_ticks_cuda(kept, ticks)
    global read_ticks_launches
    read_ticks_launches += 1
    return ticks


def stamp_through(primary: torch.Tensor, *anchors: torch.Tensor, streams: Sequence = ()):
    """Copy ``primary`` bit for bit and stamp the clock in one kernel.

    Returns ``(copy, ticks)``. Any dtype and shape; CUDA tensors must be
    contiguous. Feed the copy to the computation that must follow the
    stamp.
    """
    b = backend(primary)
    if b == "host":
        return wt_ref.stamp_through_ref(primary)
    if b == "none":
        raise RuntimeError("no wave-timer tick backend (forced 'none')")
    dev = primary.device
    if dev.type != "cuda":
        raise ValueError(f"the device tick source needs CUDA tensors, got {dev}")
    if not primary.is_contiguous():
        raise ValueError("stamp_through needs a contiguous primary on CUDA")
    with torch.cuda.device(dev):
        kept = _prepare(dev, anchors, streams)
        out = torch.empty_like(primary)
        ticks = torch.empty(2, dtype=torch.uint32, device=dev)
        stamp_through_cuda(primary, out, kept, ticks)
    global stamp_through_launches
    stamp_through_launches += 1
    return out, ticks


@allowlist.allow_callback
def ticks_numpy(words: torch.Tensor) -> np.ndarray:
    """Stamp words (uint32, any leading shape) → a numpy uint32 array.

    Pulled through their int32 view: the bits are the same, and every
    PyTorch copy takes int32.
    """
    # analysis: allow-callback
    return words.view(torch.int32).cpu().numpy().view(np.uint32)


class force_backend:
    """Context manager pinning :func:`backend` (tests / fallback drills)."""

    def __init__(self, name: Optional[str]):
        if name is not None and name not in _BACKENDS:
            raise ValueError(f"unknown wave-timer backend {name!r}")
        self._name = name
        self._prev: Optional[str] = None

    def __enter__(self):
        global _FORCED
        self._prev, _FORCED = _FORCED, self._name
        return self

    def __exit__(self, *exc):
        global _FORCED
        _FORCED = self._prev
        return False


_CALIBRATION_CACHE: dict = {}


def tick_calibration(where=None) -> _cal.TickCalibration:
    """The tick unit for tensors on ``where``: exactly 1e-9 s on the host;
    calibrated once per process and CUDA device for ``"device"``."""
    b = backend(where)
    if b == "host":
        return _cal.HOST_NS
    if b == "none":
        raise RuntimeError("no wave-timer tick backend to calibrate")
    dev = _device_of(where)
    cached = _CALIBRATION_CACHE.get(dev)
    if cached is None:
        def _read() -> int:
            return int(combine_ticks(ticks_numpy(read_ticks(device=dev))))
        cached = _CALIBRATION_CACHE[dev] = _cal.calibrate(_read)
    return cached
