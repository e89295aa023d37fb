"""Per-slot timing of the sharded backend's phase-B waves (ticks first, fences second).

On the sharded backend every Reduce slot runs its own program on its own
stream (and device), so the §4.2 "collect statistics" loop of OS4M can run
on *measured* per-slot timings instead of the synthetic work/slowdown
model that the stacked backend has to fall back to. This module is the
measurement layer:

* :class:`WaveTimings` — the accumulated ``(slots, waves)`` seconds
  buffer plus per-slot work, convertible into the ``(work, seconds)``
  observation :meth:`repro_torch.core.slot_speeds.SlotSpeedEstimator.update`
  consumes. The **primary ingestion path** is :meth:`WaveTimings.
  from_ticks`: per-slot clock stamps taken *inside* the overlapped phase-B
  walk by the ``kernels/wave_timer`` ops — no wave fencing, no host
  attribution.
* :func:`shard_ready_seconds` — the **host-timing fallback** for runs
  without a tick source: given each slot's completion marker for one
  per-slot "run" program and the dispatch timestamp, record when each
  slot finished. Only meaningful for a program without collectives (a
  collective waits on every slot), which is why the fallback executor
  fences each wave into a "copy" step (unattributed) and a "run" step
  (slot-local, timed) — trading the copy/run overlap for its clocks.

Fallback attribution: slots are awaited in *completion order* — each CUDA
slot's marker is an event recorded on its stream, polled with
``Event.query()`` — so a fast slot finishing while a straggler is still
running is stamped near its true completion instead of inheriting the
straggler's timestamp. A CPU slot's program has finished when its call
returns, so its marker is that return time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

__all__ = ["WaveTimings", "shard_ready_seconds"]

#: Completion-order polling cadence (seconds): fine enough to attribute
#: sub-millisecond waves, doubling up to a 1 ms cap while nothing lands.
_POLL_SECONDS = 5e-5
_POLL_CAP_SECONDS = 1e-3


def shard_ready_seconds(markers: Sequence, t0: float) -> np.ndarray:
    """Seconds from ``t0`` until each slot's "run" program was finished.

    ``markers[j]`` is slot ``j``'s completion marker: an object with
    ``query()`` (a ``torch.cuda.Event`` recorded on the slot's stream just
    after its program was enqueued), polled until it reports done, or a
    number — the ``time.perf_counter()`` at which a CPU slot's call
    returned. Pollable slots are stamped in **completion order**: every
    slot whose marker is done is stamped on the spot, so a fast slot is
    never billed a straggler's await.
    """
    ready = np.zeros(len(markers))
    pending = {}
    for slot, marker in enumerate(markers):
        if hasattr(marker, "query"):
            pending[slot] = marker
        else:
            ready[slot] = float(marker) - t0
    sleep_s = _POLL_SECONDS
    while pending:
        done = [s for s, marker in pending.items() if marker.query()]
        if done:
            now = time.perf_counter() - t0
            for s in done:
                ready[s] = now
                del pending[s]
            sleep_s = _POLL_SECONDS
            continue
        time.sleep(sleep_s)
        sleep_s = min(sleep_s * 2.0, _POLL_CAP_SECONDS)
    return ready


@dataclasses.dataclass
class WaveTimings:
    """Accumulated measured phase-B timings of one executed batch.

    ``seconds[j, c]`` — wall seconds slot ``j``'s wave ``c`` took
    (tick-stamped on the slot's stream, or the slot's ready time on the
    fenced fallback). ``slot_work[j]`` — the work unit per slot fed to the
    estimator. Phase-B waves are **capacity-shaped** (every slot reduces
    the same statically padded buffer), so the honest work measure is the
    shape work — identical across slots — and the implied rate
    ``work/seconds`` isolates pure per-slot speed instead of confusing an
    unevenly *loaded* slot with a slow one. An idle slot (no clusters
    assigned) still executes its padded wave, so its measurement remains a
    valid speed sample.

    ``valid`` — False when the measurement is untrustworthy: a fenced-
    fallback batch whose timed waves also built or loaded a kernel library
    (the clock would bill the build to whichever slot ran first), or a
    ticks batch with wrapped/non-finite stamps. Invalid batches are
    recorded but not fed to the estimator.
    """

    seconds: np.ndarray                    # (slots, waves)
    slot_work: Optional[np.ndarray] = None  # (slots,)
    valid: bool = True

    @staticmethod
    def empty(num_slots: int, num_waves: int) -> "WaveTimings":
        """A zeroed buffer to accumulate one batch's waves into."""
        return WaveTimings(np.zeros((num_slots, max(num_waves, 1))))

    @staticmethod
    def from_ticks(ticks, seconds_per_tick: float) -> "WaveTimings":
        """Build timings from a ``(slots, waves, 2)`` ticks buffer.

        ``ticks[j, c] = (start, end)`` are combined int64 counter stamps
        (see :func:`repro_torch.kernels.wave_timer.ref.combine_ticks`)
        bracketing slot ``j``'s wave ``c``; ``seconds_per_tick`` comes from
        the tick source's calibration. A stamp pair that wrapped or failed
        (``end < start``, non-finite) floors to zero and marks the batch
        invalid rather than feeding a negative duration downstream.
        """
        t = np.asarray(ticks, np.int64)
        if t.ndim != 3 or t.shape[-1] != 2:
            raise ValueError(f"expected (slots, waves, 2) ticks, got {t.shape}")
        dur = (t[..., 1] - t[..., 0]).astype(np.float64) * float(seconds_per_tick)
        ok = bool(np.isfinite(dur).all() and (dur >= 0).all())
        return WaveTimings(np.maximum(np.nan_to_num(dur, nan=0.0), 0.0),
                           valid=ok)

    def record(self, wave: int, wave_seconds: np.ndarray) -> None:
        """Store one wave's per-slot seconds."""
        self.seconds[:, wave] = np.asarray(wave_seconds)

    def slot_seconds(self) -> np.ndarray:
        """Total measured seconds per slot (sum over waves)."""
        return self.seconds.sum(axis=1)

    def observation(self, slot_slowdown: Optional[np.ndarray] = None):
        """The ``(work, seconds)`` pair for the speed estimator.

        ``slot_slowdown`` injects a fault into the *measurement*: slot
        ``j`` at factor ``f`` reports ``seconds * f`` — a slowdown factor
        is a **wall-clock multiplier** (2.0 ⇒ the slot reads twice as
        slow), matching ``MapReduceJob.set_slot_slowdown`` — which keeps
        fault injection on the measured path instead of reviving the
        synthetic model.
        """
        secs = self.slot_seconds()
        if slot_slowdown is not None:
            secs = secs * np.asarray(slot_slowdown, np.float64)
        work = (self.slot_work if self.slot_work is not None
                else np.ones(self.seconds.shape[0]))
        return np.asarray(work, np.float64), secs
