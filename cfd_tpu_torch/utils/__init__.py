"""Utilities: device timing with CUDA events and the profiler's device
timeline."""

from .profiling import device_op_time_ms, trace
from .timing import cuda_time_ms, spec_roofline_pts_per_s, time_ms

__all__ = ["cuda_time_ms", "time_ms", "spec_roofline_pts_per_s", "device_op_time_ms", "trace"]
