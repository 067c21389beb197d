"""Utilities: device timing with CUDA events."""

from .timing import cuda_time_ms

__all__ = ["cuda_time_ms"]
