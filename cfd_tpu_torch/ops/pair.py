"""The projection's x/y update ``(ax - dphi/dx, ay - dphi/dy)`` in one call.

The port of ``cfd_tpu/ops/pallas_pair.py`` ``pair_subtract`` (its Pallas
kernel ``_pair_sub_kernel``): the x and y components of ``u - grad(phi)``
in ``ops/poisson.project``'s compact form. On a CUDA float32 tensor it
launches K1 (``csrc/compact_lane.cu``) and K2 (``csrc/compact_strided.cu``)
with their ``acc`` epilogue and a negative spacing, ``ax + D(-dx) phi``, so
neither derivative of phi makes a round trip through memory: 3 reads and 2
writes in all, as the TPU kernel. On a CPU tensor it returns
``pair_subtract_ref``, the plain PyTorch version.

``LAUNCHES`` counts calls that launched the kernels (the two launches count
once); nothing but the launch adds to it.
"""

from __future__ import annotations

import torch

from ..schemes import CompactScheme
from . import _native, lane, strided
from .dense import dense_derivative

__all__ = ["LAUNCHES", "pair_subtract", "pair_subtract_ref"]

LAUNCHES = 0


def _check(f, ax, ay, scheme: CompactScheme) -> None:
    if scheme.derivative_order != 1:
        raise ValueError(f"pair_subtract: {scheme.name!r} is not a first-derivative scheme")
    if f.ndim < 2:
        raise ValueError(f"pair_subtract needs (..., ny, nx) fields, got {tuple(f.shape)}")
    if ax.shape != f.shape or ay.shape != f.shape:
        raise ValueError(
            f"accumuland shapes {tuple(ax.shape)}/{tuple(ay.shape)} != field {tuple(f.shape)}"
        )


def pair_subtract_ref(f, ax, ay, dy, dx, scheme: CompactScheme):
    """The plain PyTorch version: the dense operators, then the subtractions."""
    _check(f, ax, ay, scheme)
    return ax - dense_derivative(f, dx, scheme, -1), ay - dense_derivative(f, dy, scheme, -2)


def pair_subtract(f, ax, ay, dy, dx, scheme: CompactScheme):
    """``(ax - df/dx, ay - df/dy)`` of ``f`` (..., ny, nx).

    ``scheme`` is a first-derivative scheme. CUDA tensors must be float32
    and contiguous and run the kernels; a launch failure raises. CPU tensors
    take ``pair_subtract_ref``.
    """
    global LAUNCHES
    _check(f, ax, ay, scheme)
    if f.device.type == "cpu":
        return pair_subtract_ref(f, ax, ay, dy, dx, scheme)
    _native.check_operands("pair_subtract", f, ax, ay)
    outx = lane.launch(f, -float(dx), scheme, acc=ax)
    outy = strided.launch(f, -float(dy), scheme, f.ndim - 2, acc=ay)
    LAUNCHES += 1
    return outx, outy
