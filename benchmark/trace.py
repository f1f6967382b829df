"""Reading a torch.profiler trace of the measured window.

The window is the union of the ``library`` ranges the harness opens around
each ``cli.main`` call.  Device intervals are the trace's kernels, copies
and sets; the device is busy where their union lies, and idle elsewhere in
the window.  A sum of kernel times would count overlapping work twice and
time outside the window too.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Sequence[Interval], window: Sequence[Interval]
         ) -> List[Interval]:
    """The parts of disjoint sorted ``intervals`` inside disjoint sorted
    ``window``."""
    out, j = [], 0
    for a, b in window:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            lo, hi = max(a, intervals[k][0]), min(b, intervals[k][1])
            if hi > lo:
                out.append((lo, hi))
            k += 1
    return out


def length(intervals: Sequence[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def gaps(busy: Sequence[Interval], window: Sequence[Interval]
         ) -> List[Interval]:
    """The parts of ``window`` where nothing in ``busy`` runs."""
    out = []
    for a, b in window:
        t = a
        for x, y in busy:
            if y <= a or x >= b:
                continue
            if x > t:
                out.append((t, x))
            t = max(t, y)
        if t < b:
            out.append((t, b))
    return out


@dataclass
class Trace:
    """The window's device work, in seconds."""
    window: List[Interval]                     # library ranges
    device: List[Tuple[str, float, float]]     # (name, start, end)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return length(self.window)

    def busy(self) -> List[Interval]:
        return clip(union([(a, b) for _, a, b in self.device]), self.window)

    @property
    def busy_s(self) -> float:
        return length(self.busy())

    def kernel_seconds(self, needle: str) -> float:
        """Device seconds, inside the window, of kernels whose name holds
        ``needle``."""
        return length(clip(union([(a, b) for n, a, b in self.device
                                  if needle in n]), self.window))

    def top_ops(self, n: int = 10) -> List[List]:
        per = defaultdict(float)
        for name, a, b in self.device:
            per[name] += length(clip([(a, b)], self.window))
        top = sorted(per.items(), key=lambda x: -x[1])[:n]
        return [[name, s] for name, s in top if s > 0]

    def idle_by_layer(self, n: int = 10) -> List[List]:
        """Idle seconds of the device by what the host was doing: each gap
        split over the innermost host range open in each part of it
        ("library" where none is)."""
        segs = host_timeline(self.host)
        per = defaultdict(float)
        j = 0
        for a, b in gaps(self.busy(), self.window):
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            t, k = a, j
            while k < len(segs) and segs[k][0] < b:
                lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
                if lo > t:
                    per["library"] += lo - t
                if hi > lo:
                    per[segs[k][2]] += hi - lo
                    t = max(t, hi)
                k += 1
            if b > t:
                per["library"] += b - t
        top = sorted(per.items(), key=lambda x: -x[1])[:n]
        return [[name, s] for name, s in top]


def host_timeline(ranges: Sequence[Tuple[str, float, float]]
                  ) -> List[Tuple[float, float, str]]:
    """The host's nested ranges as sorted, disjoint (start, end, innermost
    range's name) segments."""
    events = sorted([(a, 1, name) for name, a, b in ranges]
                    + [(b, 0, name) for name, a, b in ranges])
    stack: List[str] = []
    segs: List[Tuple[float, float, str]] = []
    prev = None
    for t, opens, name in events:
        if stack and prev is not None and t > prev:
            segs.append((prev, t, stack[-1]))
        if opens:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        prev = t
    return segs


def from_chrome(path: str) -> Trace:
    """A Trace from an exported chrome trace (timestamps in microseconds)."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    window, device, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        a = float(ev["ts"]) * 1e-6
        b = a + float(ev["dur"]) * 1e-6
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((ev.get("name", ""), a, b))
        elif cat == "user_annotation":
            if ev.get("name") == "library":
                window.append((a, b))
            else:
                host.append((ev.get("name", ""), a, b))
    return Trace(union(window), device, host)


def profile(activities: Optional[list] = None):
    """A profiler of host and device activity, not yet started."""
    import torch

    acts = activities or [torch.profiler.ProfilerActivity.CPU,
                          torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)
