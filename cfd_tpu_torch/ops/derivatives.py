"""Single-device compact derivative API.

The port of ``cfd_tpu/ops/derivatives.py``: first and second derivatives,
``gradient``, ``divergence`` and the second-derivative ``laplacian``. Fields are
``[..., nz, ny, nx]`` with x the fastest axis, as in the JAX package.
Filters (``derivative_order=0``) are not ported yet and raise.

Methods:

* ``"kernel"`` — the hand-written CUDA kernels: ``lane`` (K1) along the
  last axis, ``strided`` (K2) along any other. They take float32 on the
  card and raise on anything else; a CPU tensor takes their plain version.
* ``"matmul"`` — the plain version: the dense operator ``T^{-1} B``
  (``ops/dense.py``), any dtype, any device.
* ``"auto"`` — ``"matmul"`` for a CPU tensor, ``"kernel"`` for any other.
  So a CUDA tensor that is not float32 raises: float64 runs on the card
  only when asked for with ``method="matmul"``. bfloat16 is not supported
  yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..schemes import SCHEME4, SCHEME4_D2, CompactScheme
from . import _native, lane, strided, vec
from .dense import dense_derivative, dense_operator

__all__ = [
    "dense_operator",
    "resolve_method",
    "derivative",
    "dfdx",
    "dfdy",
    "dfdz",
    "d2fdx2",
    "d2fdy2",
    "d2fdz2",
    "gradient",
    "divergence",
    "laplacian",
]

_METHODS = ("auto", "kernel", "matmul")


def resolve_method(method: str, f: torch.Tensor) -> str:
    """Resolve ``"auto"`` for this tensor's device (see module doc)."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {_METHODS}")
    if method != "auto":
        return method
    return "matmul" if f.device.type == "cpu" else "kernel"


def derivative(
    f: torch.Tensor,
    dx,
    scheme: CompactScheme = SCHEME4,
    *,
    axis: int = -1,
    method: str = "auto",
) -> torch.Tensor:
    """Compact derivative of ``f`` along ``axis`` with spacing ``dx``: the
    first or second derivative, as ``scheme.derivative_order`` says."""
    _native.check_order(scheme)
    axis = axis % f.ndim
    if resolve_method(method, f) == "matmul":
        return dense_derivative(f, dx, scheme, axis)
    if axis == f.ndim - 1:
        return lane.lane_derivative(f, dx, scheme)
    return strided.strided_derivative(f, dx, scheme, axis)


def dfdx(f, dx, scheme: CompactScheme = SCHEME4, *, method: str = "auto"):
    """d/dx — derivative along the last axis of ``[..., nz, ny, nx]``."""
    return derivative(f, dx, scheme, axis=-1, method=method)


def dfdy(f, dy, scheme: CompactScheme = SCHEME4, *, method: str = "auto"):
    """d/dy — derivative along the second-to-last axis."""
    return derivative(f, dy, scheme, axis=-2, method=method)


def dfdz(f, dz, scheme: CompactScheme = SCHEME4, *, method: str = "auto"):
    """d/dz — derivative along the third-to-last axis."""
    return derivative(f, dz, scheme, axis=-3, method=method)


def _d2_scheme(scheme: CompactScheme) -> CompactScheme:
    if scheme.derivative_order != 2:
        raise ValueError(
            f"scheme {scheme.name!r} is a derivative_order="
            f"{scheme.derivative_order} scheme; second-derivative ops need a "
            "derivative_order=2 scheme (e.g. get_scheme(4, derivative=2))"
        )
    return scheme


def d2fdx2(f, dx, scheme: CompactScheme = SCHEME4_D2, *, method: str = "auto"):
    """d²/dx² — compact second derivative along the last axis."""
    return derivative(f, dx, _d2_scheme(scheme), axis=-1, method=method)


def d2fdy2(f, dy, scheme: CompactScheme = SCHEME4_D2, *, method: str = "auto"):
    """d²/dy² — compact second derivative along the second-to-last axis."""
    return derivative(f, dy, _d2_scheme(scheme), axis=-2, method=method)


def d2fdz2(f, dz, scheme: CompactScheme = SCHEME4_D2, *, method: str = "auto"):
    """d²/dz² — compact second derivative along the third-to-last axis."""
    return derivative(f, dz, _d2_scheme(scheme), axis=-3, method=method)


def spacings3(spacing) -> Tuple[float, float, float]:
    """(dz, dy, dx) from a scalar spacing or a (dz, dy, dx) triple."""
    if isinstance(spacing, (tuple, list)):
        dz, dy, dx = spacing
        return (dz, dy, dx)
    return (spacing, spacing, spacing)


def gradient(
    f: torch.Tensor,
    spacing,
    scheme: CompactScheme = SCHEME4,
    *,
    method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(df/dx, df/dy, df/dz) of a scalar field ``[..., nz, ny, nx]``.

    Three single-axis derivatives; ``spacing`` is a scalar or (dz, dy, dx).
    """
    dz, dy, dx = spacings3(spacing)
    return (
        dfdx(f, dx, scheme, method=method),
        dfdy(f, dy, scheme, method=method),
        dfdz(f, dz, scheme, method=method),
    )


def divergence(
    u: Sequence[torch.Tensor],
    spacing,
    scheme: CompactScheme = SCHEME4,
    *,
    method: str = "auto",
) -> torch.Tensor:
    """div(u) of a 3-component vector field (ux, uy, uz).

    On ``"auto"`` with CUDA float32 (nz, ny, nx) components and a periodic
    d1 scheme it takes the fused route (``ops/vec.divergence_fused``: K6
    forms ``B_z uz + T_z (D1x ux + D1y uy)`` from one read of each
    component, and one z solve of K2 turns it into div u), as the JAX
    function does on the TPU. Otherwise it is the sum of three derivatives.
    """
    ux, uy, uz = u
    dz, dy, dx = spacings3(spacing)
    if (
        method == "auto"
        and ux.device.type == "cuda"
        and ux.ndim == 3
        and ux.shape == uy.shape == uz.shape
        and ux.dtype == uy.dtype == uz.dtype == torch.float32
        and scheme.periodic
        and scheme.derivative_order == 1
    ):
        return vec.divergence_fused((ux, uy, uz), dz, dy, dx, scheme)
    return (
        dfdx(ux, dx, scheme, method=method)
        + dfdy(uy, dy, scheme, method=method)
        + dfdz(uz, dz, scheme, method=method)
    )


def laplacian(
    f: torch.Tensor,
    spacing,
    scheme: CompactScheme = SCHEME4_D2,
    *,
    method: str = "auto",
) -> torch.Tensor:
    """Laplacian of ``[..., nz, ny, nx]`` by compact second derivatives.

    The sum of the three single-axis second derivatives (one solve per
    axis); ``spacing`` is a scalar or (dz, dy, dx). This is the JAX
    function's form off the TPU; its TPU-only routes that share reads
    between the axes (``d2_pair_sum``, ``lap_rhs`` + ``leading_solve``)
    are not ported.
    """
    scheme = _d2_scheme(scheme)
    dz, dy, dx = spacings3(spacing)
    return (
        d2fdx2(f, dx, scheme, method=method)
        + d2fdy2(f, dy, scheme, method=method)
        + d2fdz2(f, dz, scheme, method=method)
    )
