"""The traced sub-window: the device timeline from ``torch.profiler``.

The cell's traffic runs a number of steps (or calls) inside one capture,
with a one-cycle spin kernel (``torch.cuda._sleep(1)``) before each and
after the last, and where a step has parts (its diagnostics, then the
step) before each part: kernels launched through ``ctypes`` have no link
to an operator in the capture, so the markers are what split the
timeline. Each marker carries a label on the host (``marker(label)``); the
stretch of device time from one marker to the next is a segment of that
label. The first steps fill the card's queue and are left out; the window
is from the end of the first marker after ``start()`` to the start of the
last marker, on the device's clock.

Now and then a capture comes back with no device activity at all; the
capture is then taken again, up to ``attempts`` times. A traced run whose
every capture came back empty fails (``capture`` raises): its result line
would lack the device's busy and window seconds, which a traced line has to
carry.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections import defaultdict
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Timeline", "capture", "short_name", "from_intervals", "union_s"]

MARKER = "spin_kernel"


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total = 0.0
    end = -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


@dataclasses.dataclass
class Timeline:
    """Device activity (name, start s, end s) inside the window, in order,
    the markers left out; ``start``/``end`` bound the window; ``segments``
    are (label, start s, end s) from each marker to the next."""

    events: List[Tuple[str, float, float]]
    start: float
    end: float
    segments: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    attempts: int = 1

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return union_s((a, b) for _, a, b in self.events)

    def matching(self, pattern: re.Pattern) -> List[Tuple[str, float, float]]:
        return [e for e in self.events if pattern.search(e[0])]

    def labelled_s(self, label: str) -> float:
        """The device seconds of the segments of ``label``."""
        return sum(b - a for name, a, b in self.segments if name == label)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each gap named by the operation that ended it."""
        ops = defaultdict(float)
        for name, a, b in self.events:
            ops[short_name(name)] += b - a
        gaps = defaultdict(float)
        reach = self.start
        for name, a, b in self.events:
            if a > reach:
                gaps["idle before " + short_name(name)] += a - reach
            reach = max(reach, b)
        if self.end > reach:
            gaps["idle at the window's end"] += self.end - reach
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": order(ops), "idle_gaps": order(gaps)}


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without ``void`` and its argument list."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:limit]


def from_intervals(events, labels: Sequence[str], attempts: int = 1) -> Optional[Timeline]:
    """The window, from a capture's device activity (name, start, end):
    ``labels`` are those of the markers from the first measured one to the
    last, in the order they were issued, and are matched to the capture's
    last markers; None where the capture lacks them."""
    events = sorted(events, key=lambda e: e[1])
    marks = [e for e in events if MARKER in e[0]]
    if len(labels) < 2 or len(marks) < len(labels):
        return None
    # the capture's first activities may be missing: count from its end
    marks = marks[-len(labels):]
    start, end = marks[0][2], marks[-1][1]
    inside = [(n, max(a, start), min(b, end)) for n, a, b in events
              if MARKER not in n and b > start and a < end]
    if not inside or end <= start:
        return None
    segments = [(label, a[2], b[1]) for label, a, b in zip(labels, marks, marks[1:])]
    return Timeline(inside, start, end, segments, attempts)


def capture(run: Callable[[Callable[[str], None], Callable[[], None]], object],
            attempts: int = 4):
    """``(timeline, result)``: ``run(marker, start)`` issues some lead steps,
    calls ``start()``, and issues the measured ones inside a capture,
    calling ``marker(label)`` before each step or part of one and after the
    last, and returns what the caller needs of that run. Raises when every
    capture came back without the window's activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        labels: List[str] = []
        first: List[int] = []

        def marker(label: str = "unit") -> None:
            labels.append(label)
            torch.cuda._sleep(1)

        torch.cuda.synchronize()  # open the capture on an idle card
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            result = run(marker, lambda: first.append(len(labels)))
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        timeline = from_intervals(events, labels[first[0]:] if first else [], attempt)
        if timeline is not None:
            return timeline, result
    raise RuntimeError(f"all {attempts} profiler captures came back without the traced "
                       "window's device activity")
