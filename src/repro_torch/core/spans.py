"""Spans of one ``MapReduceJob.run``: where a job's time goes, stage by stage.

A run is three host-clock phases, timed always: ``phase_a`` (map,
statistics, the reuse decision, the pull of what the host needs),
``plan`` (the host plan; ~0 on a reused batch) and ``phase_b`` (shuffle
and reduce, any overflow re-execution, the pull of the outputs). While
spans are on, the spans inside the phases are recorded too:

* device stages (:func:`stage`), timed by a CUDA event pair on the
  stream: a stage's time is the stream's elapsed time from its start
  event to its end event, from the start of its first queued op to the
  end of its last. That is not the card's busy time: where the card waits
  inside a stage (a blocking upload in it, the host enqueueing its ops
  more slowly than the card runs them), the wait is in the stage's time.
  On CPU tensors the host clock times a stage, since CPU ops are
  synchronous. On the sharded backend each slot's stage is recorded on
  that slot's stream, so a stage's ``device_ms`` sums the slots (slot-ms);
* host spans (:func:`host`), timed by the host clock: the uploads, the
  reuse decision and the pulls. A host span that pulls from the device
  holds the host's wait for the device work queued before it.

Spans are on while the job's ``trace`` is set or a ``torch.profiler`` is
recording (:func:`enabled`). With spans off a stage costs one global
lookup and one ``None`` check, and no event is made or recorded.

The recorder adds no host sync. Its events come from a pool the job keeps
and reuses, are recorded on a stream looked up once a run (once an entry
on the sharded backend, whose slots each have a stream), and are read
with ``elapsed_time`` only once the run's last pull has drained the
streams it used; none is synchronised. It records no
``torch.profiler.record_function`` and no NVTX range: a profiler's device
trace would hold those as device activity, and the idle share read from
that trace would shrink.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

# The recorder of the run in progress while its spans are on, else None.
_active: Optional["Spans"] = None
_OFF = contextlib.nullcontext()
# ``Spans.run``'s stream for a job whose stages run on several streams:
# each entry records on the stream current at the entry.
CURRENT = "current"


@dataclasses.dataclass
class Span:
    """One span of a run, all its entries in one record.

    ``job`` is the run's sequence number on its ``MapReduceJob``, shared by
    every span of the run. ``parent`` is the name of the span it was first
    entered in (``None`` for a phase: the run is the root). ``host_start``
    and ``host_end`` are ``time.perf_counter()`` seconds at the first entry
    and at the last exit; ``host_ms`` sums the entries' host time.
    ``device_ms``, of a device stage only, sums the entries' stream time
    (idle inside them included) less that of the device stages inside them
    (its self time). ``count`` is the number of entries in the run.
    """

    name: str
    job: int
    parent: Optional[str]
    host_start: float
    host_end: float = 0.0
    host_ms: float = 0.0
    device_ms: Optional[float] = None
    count: int = 0

    @property
    def ms(self) -> float:
        """The span's time in ``last_phase_ms``: device ms of a device
        stage, host ms of any other span."""
        return self.host_ms if self.device_ms is None else self.device_ms


def enabled(trace: bool) -> bool:
    """Whether a run records spans: its job's ``trace``, or a profiler recording."""
    return trace or torch.autograd.profiler._is_profiler_enabled


def stage(name: str):
    """``with stage(name):`` a device stage of the run in progress."""
    rec = _active
    if rec is None:
        return _OFF
    return rec._entry(name, True)


def host(name: str):
    """``with host(name):`` a host span of the run in progress."""
    rec = _active
    if rec is None:
        return _OFF
    return rec._entry(name, False)


class _Entry:
    """One entry of a span, for ``with``: its host clock, and a device
    stage's event pair."""

    __slots__ = ("rec", "name", "on_device", "span", "parent", "stream", "events")

    def __init__(self, rec: "Spans", name: str, on_device: bool):
        self.rec, self.name, self.on_device = rec, name, on_device

    def __enter__(self):
        rec = self.rec
        outer = rec._open[-1][0] if rec._open else None
        self.parent = outer if outer is not None and outer.device_ms is not None else None
        span = self.span = rec._begin(self.name, time.perf_counter())
        self.events = None
        if self.on_device:
            if span.device_ms is None:
                span.device_ms = 0.0
            if rec._stream is not None:
                self.stream, self.events = rec._events()
                self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        rec, events = self.rec, self.events
        if events is not None:
            events[1].record(self.stream)
            rec._timed.append((self.span, self.parent, events[0], events[1]))
        ms = rec._end(time.perf_counter())
        if self.on_device and events is None:
            self.span.device_ms += ms
            if self.parent is not None:
                self.parent.device_ms -= ms
        return False


class Spans:
    """A job's span recorder: its event pool and the spans of its last run."""

    def __init__(self):
        self.runs = 0
        self.records: List[Span] = []
        self._on = False
        self._stream = None
        self._by_name: Dict[str, Span] = {}
        self._open: List[Tuple[Span, float]] = []
        # (stage, its device parent or None, start event, end event)
        self._timed: list = []
        self._pool: Dict[int, list] = {}
        self._taken: Dict[int, int] = {}

    @contextlib.contextmanager
    def run(self, on: bool, stream=None):
        """One run, inside which :meth:`phase` opens the phases. ``on``
        records the spans inside them. ``stream`` is where device stages
        record their events: a CUDA stream, :data:`CURRENT` (the stream
        current at each entry), or ``None`` to time them by the host clock
        (CPU tensors)."""
        global _active
        self.runs += 1
        self._on, self._stream = on, stream
        self.records, self._by_name, self._open, self._timed = [], {}, [], []
        self._taken = {}
        outer, _active = _active, (self if on else None)
        try:
            yield self
        finally:
            _active = outer

    def phase(self, name: Optional[str]) -> None:
        """Close the open phase and open ``name`` (``None`` only closes):
        the host clock, whether spans are on or not."""
        now = time.perf_counter()
        if self._open:
            self._end(now)
        if name is not None:
            self._begin(name, now)

    def finish(self) -> Tuple[dict, List[Span]]:
        """``(last_phase_ms, last_spans)`` of the run, once its last pull is
        done: each phase's host ms, and with spans on each other span's
        :attr:`Span.ms`; the records with spans on, else none."""
        for span, parent, start, end in self._timed:
            ms = start.elapsed_time(end)
            span.device_ms += ms
            if parent is not None:
                parent.device_ms -= ms
        self._timed = []
        return {s.name: s.ms for s in self.records}, (self.records if self._on else [])

    def _entry(self, name: str, on_device: bool) -> _Entry:
        return _Entry(self, name, on_device)

    def _begin(self, name: str, now: float) -> Span:
        span = self._by_name.get(name)
        if span is None:
            parent = self._open[-1][0].name if self._open else None
            span = self._by_name[name] = Span(name, self.runs, parent, now)
            self.records.append(span)
        span.count += 1
        self._open.append((span, now))
        return span

    def _end(self, now: float) -> float:
        """Close the innermost open span; returns the entry's host ms."""
        span, start = self._open.pop()
        span.host_end = now
        ms = (now - start) * 1e3
        span.host_ms += ms
        return ms

    def _events(self):
        """``(stream, (start, end))``: the stream to record on and a pair
        of timing events on its device, from the pool."""
        stream = self._stream
        if stream is CURRENT:
            stream = torch.cuda.current_stream()
        dev = stream.device_index
        pool = self._pool.setdefault(dev, [])
        i = self._taken.get(dev, 0)
        if i == len(pool):
            pool.append((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True)))
        self._taken[dev] = i + 1
        return stream, pool[i]
