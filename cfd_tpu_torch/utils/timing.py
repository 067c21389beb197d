"""Device timing on the card with CUDA events.

The CUDA counterpart of ``cfd_tpu/utils/timing.py``: warm up, then time
each of ``iters`` calls between two events on the current stream and take
the median. A call's time is the device time from its first to its last
kernel; host time between calls is not in it.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

__all__ = ["cuda_time_ms"]


def cuda_time_ms(fn: Callable[[], object], *, warmup: int = 3, iters: int = 20) -> float:
    """Median device milliseconds of one ``fn()`` call (needs a card)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms times the card; no CUDA device here")
    for _ in range(warmup):
        fn()
    pairs = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)
