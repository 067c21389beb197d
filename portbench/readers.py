"""What a per-layer metric reads, and the arithmetic they share.

Each file ``metrics/<name>.py`` defines ``read(reading) -> float | None``,
and, where it holds the timeline against a launch counter of the program,
``COUNTER = (module under cfd_tpu_torch.ops, attribute, key or None)``: the
harness reads that counter around the traced sub-window. ``reading`` is a
``Reading``; a metric that finds nothing to read returns None, and the
harness leaves it out of the result and says why on standard error
(``Reading.note``).
"""

from __future__ import annotations

import dataclasses
import importlib
import re
import sys
from typing import Dict, List, Optional, Tuple

from . import counts
from .trace import Timeline

__all__ = ["Reading", "read_counter", "kernel_share", "single_kernel_share", "idle_pct",
           "paired", "device_ops"]


@dataclasses.dataclass
class Reading:
    """A traced run's readings: the grid and the traffic mix; the traced
    sub-window's device timeline and the units (steps or calls) it
    measured; and, by metric, the launches that the metric's ``COUNTER``
    counted over those units (None where the program has no such
    counter)."""

    shape: Tuple[int, int, int]
    mix: dict
    timeline: Timeline
    traced_units: int
    launches: Dict[str, Optional[int]]

    @property
    def points(self) -> int:
        nz, ny, nx = self.shape
        return nz * ny * nx

    def note(self, metric: str, why: str) -> None:
        print(f"portbench: {metric} left out: {why}", file=sys.stderr)


def read_counter(spec) -> Optional[int]:
    """The program's launch counter ``(module, attribute, key)`` now: one
    count a call that launched the kernel, whatever number of device
    kernels the launch runs; None where the program no longer has it."""
    module, attr, key = spec
    try:
        value = getattr(importlib.import_module(f"cfd_tpu_torch.ops.{module}"), attr)
        return int(value if key is None else value[key])
    except (ImportError, AttributeError, KeyError, TypeError):
        return None


def kernel_share(r: Reading, metric: str, launches: List[Tuple[float, float]],
                 expected: int) -> Optional[float]:
    """A kernel's share of its roofline, in percent: the least time of its
    launches over their device time.

    ``launches`` lists (bound seconds, device seconds) of each launch the
    timeline holds; their number has to equal the metric's counter over the
    traced sub-window and ``expected``, or the match is wrong and the
    metric is left out.
    """
    made = r.launches.get(metric)
    if made is None:
        r.note(metric, "the program has no launch counter for it")
        return None
    if not launches or len(launches) != made or made != expected:
        r.note(metric, f"{len(launches)} launches on the timeline, {made} counted, "
                       f"{expected} expected")
        return None
    bound = sum(b for b, _ in launches)
    device = sum(d for _, d in launches)
    return 100.0 * bound / device


def single_kernel_share(r: Reading, metric: str, pattern: re.Pattern, nbytes: float,
                        flops: float, per_unit: int) -> Optional[float]:
    """``kernel_share`` of a kernel that runs as one launch of one device
    kernel matching ``pattern``, ``per_unit`` launches a step or call, each
    moving ``nbytes`` and doing ``flops``."""
    bound = counts.bound_s(nbytes, flops)
    launches = [(bound, b - a) for _, a, b in r.timeline.matching(pattern)]
    return kernel_share(r, metric, launches, per_unit * r.traced_units)


def idle_pct(r: Reading) -> float:
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    return 100.0 * (1.0 - r.timeline.busy_s / r.timeline.window_s)


def device_ops(r: Reading) -> List[Tuple[str, float, float]]:
    """The timeline's kernels: its device activity less copies and fills."""
    return [e for e in r.timeline.events if not e[0].startswith(("Memcpy", "Memset"))]


def paired(events, first: re.Pattern, second: re.Pattern) -> List[float]:
    """Device seconds of each launch that runs a kernel matching ``first``
    directly followed by one matching ``second`` (a y and an x phase): the
    sum of the two."""
    out = []
    for (n0, a0, b0), (n1, a1, b1) in zip(events, events[1:]):
        if first.search(n0) and second.search(n1):
            out.append((b0 - a0) + (b1 - a1))
    return out
