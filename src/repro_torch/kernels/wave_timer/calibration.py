"""Tick → seconds conversion for the wave-timer counters.

Tick *differences* are only useful to the slot-speed estimator once they
are wall-clock seconds, and the seconds-per-tick scale depends on the
tick source: host ``perf_counter_ns`` ticks are exactly 1e-9 s by
definition, while a device counter's unit must be *measured* once (the
H100's ``%globaltimer`` is specified in nanoseconds; calibration checks
it rather than trusting it). :func:`calibrate`
brackets the device counter with host sleeps — read ticks, sleep a known
interval, read again, take the median implied scale — which is accurate
to the dispatch overhead over the sleep length (≲2% at the defaults) and
needs no hardware documentation.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

__all__ = ["TickCalibration", "HOST_NS", "calibrate"]


@dataclasses.dataclass(frozen=True)
class TickCalibration:
    """A tick unit: ``seconds_per_tick`` plus the two conversions."""

    seconds_per_tick: float
    source: str = "unknown"     # "host-ns" | "device" | test labels

    def __post_init__(self):
        """Reject non-positive or non-finite scales at construction."""
        spt = self.seconds_per_tick
        if not (np.isfinite(spt) and spt > 0):
            raise ValueError(f"seconds_per_tick must be finite > 0, got {spt}")

    def ticks_to_seconds(self, ticks) -> np.ndarray:
        """Tick counts/differences → float64 seconds."""
        return np.asarray(ticks, np.float64) * self.seconds_per_tick

    def seconds_to_ticks(self, seconds) -> np.ndarray:
        """Seconds → nearest whole tick counts (int64)."""
        return np.rint(
            np.asarray(seconds, np.float64) / self.seconds_per_tick
        ).astype(np.int64)


#: The host (CPU-tensor) unit — ``perf_counter_ns`` ticks.
HOST_NS = TickCalibration(1e-9, source="host-ns")


def calibrate(read_ticks_fn, *, sleep_seconds: float = 0.02,
              repeats: int = 5) -> TickCalibration:
    """Measure seconds-per-tick of an opaque counter by host bracketing.

    ``read_ticks_fn()`` must return one *combined* int64 tick value (see
    :func:`repro_torch.kernels.wave_timer.ref.combine_ticks`) and block until
    the stamp is real (device reads must sync). Each repeat times a host
    ``sleep`` between two stamps; the median ratio rejects outlier
    repeats that hit a scheduler hiccup.
    """
    scales = []
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        a = int(read_ticks_fn())
        time.sleep(sleep_seconds)
        b = int(read_ticks_fn())
        t1 = time.perf_counter()
        if b > a:
            scales.append((t1 - t0) / (b - a))
    if not scales:
        raise RuntimeError("tick counter never advanced during calibration")
    return TickCalibration(float(np.median(scales)), source="device")
