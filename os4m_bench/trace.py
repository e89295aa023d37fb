"""The device trace of a ``--trace 1`` window, and its reduction.

``torch.profiler`` records CUDA activity only (kernels, copies, memsets;
no host ops, whose records would slow the host path being measured). Its
timestamps are on the profiler's clock, so a marker kernel is launched on
an idle device at a known host time at each end of the window: the first
and last device events. Their offset maps the host's phase spans onto the
trace, which names each idle gap by what the host was doing. The reader
of ``chip_smoke.py:profile_run`` (raw kineto events, union of intervals),
copied.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch

# A kernel's demangled name runs to hundreds of characters; its head
# (template and first arguments) names it.
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    """Device events of the window on the host's clock, in seconds from the
    window's start: ``(name, start_s, duration_s)``."""

    events: List[Tuple[str, float, float]]
    window_s: float

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (union)."""
        busy, end = 0.0, float("-inf")
        for _, lo, dur in sorted(self.events, key=lambda e: e[1]):
            busy += max(0.0, lo + dur - max(lo, end))
            end = max(end, lo + dur)
        return busy

    def kernel_s(self, *patterns: str) -> float:
        """Device seconds of the events whose name contains every pattern of
        one of ``patterns`` (each a ``&``-joined list of substrings)."""
        parts = [p.split("&") for p in patterns]
        return sum(dur for name, _, dur in self.events
                   if any(all(s in name for s in p) for p in parts))

    def top_ops(self, count: int = 10) -> list:
        """``[[name, seconds], ...]``: the device operations that took most
        time, each name cut to :data:`NAME_CHARS` characters."""
        by_name = {}
        for name, _, dur in self.events:
            name = name[:NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + dur
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda r: -r[1])[:count]]

    def idle_gaps(self, host_spans: list, count: int = 10) -> list:
        """``[[what the host did, seconds], ...]``: the longest idle gaps on
        the device, each named by the host span ``(label, start_s, end_s)``
        that holds its middle (``"harness"`` between spans)."""
        gaps, end = [], 0.0
        for _, lo, dur in sorted(self.events, key=lambda e: e[1]):
            if lo > end:
                gaps.append((end, lo))
            end = max(end, lo + dur)
        if self.window_s > end:
            gaps.append((end, self.window_s))
        named = []
        for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:count]:
            mid = (lo + hi) / 2
            label = next((s[0] for s in host_spans if s[1] <= mid < s[2]), "harness")
            named.append([label, hi - lo])
        return named


class DeviceTracer:
    """``with DeviceTracer(device) as t: ...`` traces the block; then
    ``t.trace`` holds its :class:`Trace`. ``t.start`` is the host clock
    (``time.perf_counter``) at the window's start."""

    def __init__(self, device):
        self.device = device
        self.trace: Optional[Trace] = None
        self.start = self.end = 0.0
        self._marker = torch.zeros(1, device=device)

    def _mark(self) -> float:
        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self._marker.add_(1.0)
        torch.cuda.synchronize(self.device)
        return t

    def __enter__(self) -> "DeviceTracer":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.start = self._mark()
        return self

    def __exit__(self, *exc) -> None:
        self.end = self._mark()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        on_device = torch.autograd.DeviceType.CUDA
        raw = sorted(((e.name(), e.start_ns(), e.duration_ns())
                      for e in self._prof.profiler.kineto_results.events()
                      if e.device_type() == on_device), key=lambda e: e[1])
        window_s = self.end - self.start
        if len(raw) < 2:
            self.trace = Trace([], window_s)
            return
        # The markers ran first and last; the start marker pins the clocks.
        zero = raw[0][1]
        events = [(name, (t - zero) / 1e9, ns / 1e9) for name, t, ns in raw[1:-1]]
        self.trace = Trace(events, window_s)
