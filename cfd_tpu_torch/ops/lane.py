"""Compact derivative along the contiguous last axis (d/dx, d²/dx²): kernel K1.

The port of ``cfd_tpu/ops/pallas_lane.py``. On a CUDA float32 tensor
``lane_derivative`` launches ``compact_lane`` (``csrc/compact_lane.cu``),
which replaces both of that module's derivative kernels: the fold form
``_lane_fold_kernel`` (first and second derivatives and filters) and the
roll form ``_lane_kernel`` (first). The scheme's tables select the
derivative, or the filter (``derivative_order=0``, ``schemes.get_filter``:
no spacing scale). On a CPU tensor it returns ``lane_derivative_ref``, the
plain PyTorch version.

``LAUNCHES`` counts the launches of ``lane_derivative``, so that a run can
show that its path went through the kernel, and ``MODE_LAUNCHES`` the same
launches by mode (``"derivative"`` or ``"filter"``); nothing but the launch
adds to them. ``launch`` is the bare launch, with the kernel's ``acc``
epilogue (``f' + acc``), for ``ops/pair.py``, which counts its own calls.
"""

from __future__ import annotations

import ctypes

import torch

from ..schemes import CompactScheme
from . import _native
from .dense import dense_derivative

__all__ = ["LAUNCHES", "MODE_LAUNCHES", "launch", "lane_derivative", "lane_derivative_ref"]

LAUNCHES = 0
MODE_LAUNCHES = {"derivative": 0, "filter": 0}


def lane_derivative_ref(f: torch.Tensor, dx, scheme: CompactScheme) -> torch.Tensor:
    """The plain PyTorch version: the dense operator along the last axis."""
    return dense_derivative(f, dx, scheme, -1)


def lane_derivative(f: torch.Tensor, dx, scheme: CompactScheme) -> torch.Tensor:
    """Compact first or second derivative, or filter, of ``f`` along its
    last axis.

    CUDA tensors must be float32 and contiguous and run the kernel; a line
    too short for the scheme, or too long for one block's shared memory,
    and a launch failure raise. CPU tensors take ``lane_derivative_ref``.
    """
    global LAUNCHES
    _native.check_order(scheme)
    if f.device.type == "cpu":
        return lane_derivative_ref(f, dx, scheme)
    out = launch(f, dx, scheme)
    LAUNCHES += 1
    MODE_LAUNCHES["filter" if scheme.derivative_order == 0 else "derivative"] += 1
    return out


def launch(f: torch.Tensor, dx, scheme: CompactScheme, acc: torch.Tensor = None) -> torch.Tensor:
    """One launch of the kernel on a CUDA tensor, ``f' + acc`` with ``acc``
    (``acc`` contiguous, of f's shape), counted by the caller."""
    _native.check_operands("compact_lane", f, *((acc,) if acc is not None else ()))
    if f.ndim == 0:
        raise ValueError("compact_lane needs at least one axis")
    if acc is not None and acc.shape != f.shape:
        raise ValueError(f"acc shape {tuple(acc.shape)} != field shape {tuple(f.shape)}")
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
            acc.data_ptr() if acc is not None else None,
            lines,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "compact_lane")
    return out
