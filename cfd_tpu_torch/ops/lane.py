"""Compact derivative along the contiguous last axis (d/dx): kernel K1.

The port of ``cfd_tpu/ops/pallas_lane.py``. On a CUDA float32 tensor
``lane_derivative`` launches ``compact_lane`` (``csrc/compact_lane.cu``),
which replaces both of that module's first-derivative kernels (the fold
form ``_lane_fold_kernel`` and the roll form ``_lane_kernel``). On a CPU
tensor it returns ``lane_derivative_ref``, the plain PyTorch version.

``LAUNCHES`` counts kernel launches, so that a run can show that its path
went through the kernel; nothing but the launch adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from ..schemes import CompactScheme
from . import _native
from .dense import dense_derivative

__all__ = ["LAUNCHES", "lane_derivative", "lane_derivative_ref"]

LAUNCHES = 0


def lane_derivative_ref(f: torch.Tensor, dx, scheme: CompactScheme) -> torch.Tensor:
    """The plain PyTorch version: the dense operator along the last axis."""
    return dense_derivative(f, dx, scheme, -1)


def lane_derivative(f: torch.Tensor, dx, scheme: CompactScheme) -> torch.Tensor:
    """Compact derivative of ``f`` along its last axis.

    CUDA tensors must be float32 and contiguous and run the kernel; a line
    too short for the scheme, or too long for one block's shared memory,
    and a launch failure raise. CPU tensors take ``lane_derivative_ref``.
    """
    global LAUNCHES
    if f.device.type == "cpu":
        return lane_derivative_ref(f, dx, scheme)
    if f.device.type != "cuda":
        raise ValueError(f"lane_derivative: no kernel for device {f.device}")
    if f.dtype != torch.float32:
        raise TypeError(f"compact_lane takes float32, got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("compact_lane takes a contiguous tensor")
    if f.ndim == 0:
        raise ValueError("compact_lane needs at least one axis")
    n = f.shape[-1]
    coef, tab = _native.launch_tables(scheme, n, float(dx), f.device)
    out = torch.empty_like(f)
    lines = f.numel() // n
    if lines == 0:
        return out
    with torch.cuda.device(f.device):
        err = _native.library().cfd_compact_lane(
            f.data_ptr(),
            out.data_ptr(),
            tab.data_ptr(),
            ctypes.byref(coef),
            lines,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "compact_lane")
    LAUNCHES += 1
    return out
