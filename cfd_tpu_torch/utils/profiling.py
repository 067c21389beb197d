"""Profiler integration: trace capture and device-timeline op timing.

The counterpart of ``cfd_tpu/utils/profiling.py`` on ``torch.profiler``
(CUPTI), where the JAX package reads the XLA profiler's xplane capture.
``trace`` writes a Chrome trace of the enclosed work; ``device_op_time_ms``
reads the kernels' own durations back out of a capture, the device's
clock with no host time in it.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace", "device_op_time_ms", "kernel_ms_by_name"]


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of the enclosed work into
    ``logdir/trace.json`` (Chrome trace format, for Perfetto).

    Example:
        with cfd_tpu_torch.utils.trace("traces/dfdx"):
            df = cfd_tpu_torch.dfdx(f, dx); torch.cuda.synchronize()
    """
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _bench_scale(x):
    # one read and one write of x: the in-capture copy floor, and a new
    # input for every call
    return x * 1.000001


def _mark(x):
    # a spin kernel of one cycle: it splits the device timeline between the
    # calls (nothing that is timed launches one)
    if x.device.type == "cuda":
        torch.cuda._sleep(1)


def _device_events(prof):
    # the device activities of a capture, by start
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)


def device_op_time_ms(fn, x, *, iters: int = 10):
    """Time ``fn(x)`` by the profiler's device timeline: ``(op_ms,
    floor_ms, n)``.

    Runs ``out = fn(scale(out))`` ``iters`` times inside one capture, with
    a marker kernel before each scale and each call. The device runs them
    in order, so the activities (kernels, copies) between two markers are
    one call's, or one scale's: a call's device time is the sum of their
    durations, the gaps between them not included. ``op_ms`` is the least
    over the calls, ``floor_ms`` the least of the scale (one read and one
    write of x, in the same window) and ``n`` the calls. The markers stand
    in for the profiler's links from a launch to its operator, which a
    kernel launched through ``ctypes`` does not have. The spans are read
    from the end of the capture, whose first activities the profiler may
    miss. ``(inf, inf, 0)`` where the capture has no device timeline, as
    on the CPU, or an incomplete one: fewer spans than calls and scales,
    or a scale that is not one kernel (the card's profiler now and then
    returns a capture with no device activity at all, whether it opens on
    an idle card or behind queued work).
    """
    cuda = x.device.type == "cuda"
    out = fn(_bench_scale(x))  # warm up: builds, tables, allocator
    if cuda:
        torch.cuda.synchronize(x.device)  # open on an idle card
    with profile(activities=_activities()) as prof:
        _mark(x)  # leads the capture, where activities may go missing
        for _ in range(iters):
            _mark(x)
            y = _bench_scale(out)
            _mark(x)
            out = fn(y)
        if cuda:
            torch.cuda.synchronize(x.device)
    spans = []  # [activities, microseconds] after each marker
    for e in _device_events(prof):
        if "spin_kernel" in e.name:
            spans.append([0, 0.0])
        elif spans:
            spans[-1][0] += 1
            spans[-1][1] += e.time_range.elapsed_us()
    spans = spans[-2 * iters:]  # scale, call, scale, call, ...
    if len(spans) < 2 * iters or any(count != 1 for count, _ in spans[0::2]):
        return math.inf, math.inf, 0
    ops = [us for _, us in spans[1::2]]
    return min(ops) / 1e3, min(us for _, us in spans[0::2]) / 1e3, len(ops)


def kernel_ms_by_name(fn, *, calls: int = 10) -> dict:
    """Mean device milliseconds one ``fn()`` call spends in each kernel, by
    the kernel's name, from the profiler's device timeline: the kernels'
    own durations, no gaps and no host time. So a launch of two kernels
    (the y and x phases of ``csrc/xy_phase.cuh``) is read phase by phase.
    ``{}`` where the capture has no device activity: on the CPU, or when
    the card's profiler returns an empty capture twice running."""
    fn()  # warm up: builds, tables, allocator
    cuda = torch.cuda.is_available()
    for _ in range(2):
        if cuda:
            torch.cuda.synchronize()  # open on an idle card
        with profile(activities=_activities()) as prof:
            for _ in range(calls):
                fn()
            if cuda:
                torch.cuda.synchronize()
        out = {}
        for e in _device_events(prof):
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
        if out:
            return out
    return {}
