"""Compact derivative along any strided axis (d/dy, d/dz and their second
derivatives): kernel K2.

The port of ``cfd_tpu/ops/pallas_sublane.py`` and
``cfd_tpu/ops/pallas_leading.py``. The field is viewed as
``(outer, n, inner)`` with the line along the middle axis: for a
``(nz, ny, nx)`` field, y is ``(nz, ny, nx)`` and z is ``(1, nz, ny*nx)``.
On a CUDA float32 tensor ``strided_derivative`` launches
``compact_strided`` (``csrc/compact_strided.cu``), which replaces
``_sublane_kernel`` (first derivatives), ``_sublane_fold_kernel`` (second
derivatives) and the plain derivative mode of ``_leading_kernel``. Filters
(``derivative_order=0``) are not ported yet and raise. On a CPU tensor it
returns ``strided_derivative_ref``, the plain PyTorch version.

``LAUNCHES`` counts kernel launches; nothing but the launch adds to it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..schemes import CompactScheme
from . import _native
from .dense import dense_derivative

__all__ = ["LAUNCHES", "strided_derivative", "strided_derivative_ref"]

LAUNCHES = 0


def strided_derivative_ref(
    f: torch.Tensor, dx, scheme: CompactScheme, axis: int
) -> torch.Tensor:
    """The plain PyTorch version: the dense operator along ``axis``."""
    return dense_derivative(f, dx, scheme, axis)


def strided_derivative(
    f: torch.Tensor, dx, scheme: CompactScheme, axis: int
) -> torch.Tensor:
    """Compact first or second derivative of ``f`` along ``axis``, any axis
    but the last.

    CUDA tensors must be float32 and contiguous and run the kernel; a line
    too short for the scheme and a launch failure raise. CPU tensors take
    ``strided_derivative_ref``.
    """
    global LAUNCHES
    _native.check_order(scheme)
    axis = axis % f.ndim
    if axis == f.ndim - 1:
        raise ValueError("the last axis is contiguous: use lane_derivative")
    if f.device.type == "cpu":
        return strided_derivative_ref(f, dx, scheme, axis)
    _native.check_operands("compact_strided", f)
    coef, tab = _native.launch_tables(scheme, f.shape[axis], float(dx), f.device)
    out = torch.empty_like(f)
    outer = math.prod(f.shape[:axis])
    inner = math.prod(f.shape[axis + 1 :])
    if outer * inner == 0:
        return out
    with torch.cuda.device(f.device):
        err = _native.library().cfd_compact_strided(
            f.data_ptr(),
            out.data_ptr(),
            tab.data_ptr(),
            ctypes.byref(coef),
            outer,
            inner,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "compact_strided")
    LAUNCHES += 1
    return out
