"""Device timing on the card with CUDA events.

The CUDA counterpart of ``cfd_tpu/utils/timing.py``: warm up, then time
each of ``iters`` calls between two events on the current stream and take
the median. A call's time is the device time from its first to its last
kernel; host time between calls is not in it.

Host time inside a call is, when the card waits on it: the start event
runs as soon as it is issued, and the call's first kernel only once the
host has issued it. For a call whose kernels take less than the host's
issue time (one launch of a small kernel through a Python wrapper),
``queued=True`` issues every timed call behind a spin kernel that holds
the card until the host has issued them all, so that each pair of events
brackets device work alone.

``time_ms`` is what the benchmark scripts time with: ``cuda_time_ms``
(queued) on the card, a host-clock median on the CPU, where the scripts
run in the tests. ``spec_roofline_pts_per_s`` is the scripts'
plausibility ceiling, from the card's published memory rate.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

__all__ = ["cuda_time_ms", "time_ms", "spec_roofline_pts_per_s", "HBM_BYTES_PER_S",
           "F32_FLOPS_PER_S", "BF16_FLOPS_PER_S", "TF32_FLOPS_PER_S"]

# The H100 SXM's published rates (NVIDIA's data sheet, at 700 W): HBM3,
# shared by reads and writes; float32 outside the tensor cores; bf16 and
# TF32 operands with float32 accumulation on the tensor cores (dense).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12

_SPIN_HZ = 2e9  # spin cycles a second: above any H100 clock, so the spin only lasts longer


def cuda_time_ms(fn: Callable[[], object], *, warmup: int = 3, iters: int = 20,
                 queued: bool = False) -> float:
    """Median device milliseconds of one ``fn()`` call (needs a card)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms times the card; no CUDA device here")
    for _ in range(warmup):
        fn()
    pairs = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    if queued:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0  # an upper bound of one call's issue time
        torch.cuda._sleep(int(_SPIN_HZ * (2 * iters * host_s + 1e-3)))
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def time_ms(fn: Callable[[], object], device, *, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of one ``fn()`` call on ``device``: device time
    (``cuda_time_ms``, queued) on a CUDA device, host time around a
    synchronous call on the CPU."""
    if torch.device(device).type == "cuda":
        return cuda_time_ms(fn, warmup=warmup, iters=iters, queued=True)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def spec_roofline_pts_per_s(itemsize: int = 4) -> float:
    """The most points a second that a one-read, one-write streaming op on
    ``itemsize``-byte values can pass at the card's published memory rate:
    a measured rate well above it is a timing artifact, not a kernel."""
    return HBM_BYTES_PER_S / (2 * itemsize)
