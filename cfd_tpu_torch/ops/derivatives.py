"""Single-device compact derivative API.

The port of ``cfd_tpu/ops/derivatives.py``: first and second derivatives,
compact filters (``filter_field``), ``gradient``, ``divergence``, ``curl``
and the second-derivative ``laplacian``. Fields are ``[..., nz, ny, nx]``
with x the fastest axis, as in the JAX package.

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

The composites take the JAX function's routes: where it takes a Pallas
kernel on the TPU, ``"auto"`` takes the matching kernel for CUDA float32
tensors, decided up front by the ``*_supported`` predicates of
``ops/pair.py``, ``ops/adv_lap.py`` and ``ops/vec.py``; elsewhere it sums
single derivatives, as the JAX function does off the TPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..schemes import SCHEME4, SCHEME4_D2, CompactScheme, get_filter
from . import _native, adv_lap, lane, pair, strided, vec
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
    "filter_field",
    "gradient",
    "divergence",
    "curl",
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
    first or second derivative, or the filter (no spacing scale), as
    ``scheme.derivative_order`` says."""
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


def filter_field(
    f: torch.Tensor,
    scheme: CompactScheme = None,
    *,
    axis=None,
    method: str = "auto",
) -> torch.Tensor:
    """Apply a compact low-pass filter (``schemes.get_filter``; default
    ``get_filter()``) to ``f``.

    ``axis=None`` filters the three trailing axes in turn (x, then y, then
    z); an int filters one axis. The filter is the derivative's tridiagonal
    solve with ``derivative_order=0`` and no spacing scale: on a CUDA
    float32 tensor K1 along x and K2 along y and z, in filter mode.
    """
    if scheme is None:
        scheme = get_filter()
    if scheme.derivative_order != 0:
        raise ValueError(
            f"scheme {scheme.name!r} is not a filter (derivative_order="
            f"{scheme.derivative_order}); build one with schemes.get_filter"
        )
    for ax in (-1, -2, -3) if axis is None else (axis,):
        f = derivative(f, 1.0, scheme, axis=ax, method=method)
    return f


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
    """(df/dx, df/dy, df/dz) of a scalar field ``[..., nz, ny, nx]``;
    ``spacing`` is a scalar or (dz, dy, dx).

    On ``"auto"`` with a CUDA float32 field of 3 or more axes and a
    first-derivative scheme (``pair.pair_supported``), (df/dx, df/dy) come
    from one K7 launch (``pair.gradient_pair``) and df/dz from K2, as the
    JAX function takes its pair kernel on the TPU. Otherwise three
    single-axis derivatives.
    """
    dz, dy, dx = spacings3(spacing)
    if (
        method == "auto"
        and f.device.type == "cuda"
        and f.ndim >= 3
        and pair.pair_supported(scheme, f.shape[-2], f.shape[-1], f.dtype)
    ):
        gx, gy = pair.gradient_pair(f, dy, dx, scheme)
        return gx, gy, dfdz(f, dz, scheme, method=method)
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

    On ``"auto"`` with CUDA (nz, ny, nx) components that
    ``vec.div_fused_supported`` takes (float32, a periodic d1 scheme, nz
    of at least the z stencil, planes within an x block) it takes the fused
    route (``ops/vec.divergence_fused``: K6 forms ``B_z uz + T_z (D1x ux +
    D1y uy)`` from one read of each component, and one z solve of K2 turns
    it into div u), as the JAX function does on the TPU. Otherwise it is
    the sum of three derivatives.
    """
    ux, uy, uz = u
    dz, dy, dx = spacings3(spacing)
    if (
        method == "auto"
        and ux.device.type == "cuda"
        and ux.ndim == 3
        and ux.shape == uy.shape == uz.shape
        and ux.dtype == uy.dtype == uz.dtype
        and vec.div_fused_supported(scheme, *ux.shape, ux.dtype)
    ):
        return vec.divergence_fused((ux, uy, uz), dz, dy, dx, scheme)
    return (
        dfdx(ux, dx, scheme, method=method)
        + dfdy(uy, dy, scheme, method=method)
        + dfdz(uz, dz, scheme, method=method)
    )


def curl(
    u: Sequence[torch.Tensor],
    spacing,
    scheme: CompactScheme = SCHEME4,
    *,
    method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """curl(u) = (wx, wy, wz) of a 3-component vector field (ux, uy, uz).

    On ``"auto"`` with CUDA float32 (nz, ny, nx) components and a periodic
    d1 scheme (``vec.curl_fused_supported``) it takes the fused route, as
    the JAX function does on the TPU: K10 forms wz and the right-hand sides
    of wx and wy from one read of each component, and two z solves of K2
    finish them (``vec.curl_fused``). Otherwise uz's two derivatives come
    from one K7 launch where ``pair.pair_supported`` holds, and the other
    four are single derivatives.
    """
    ux, uy, uz = u
    dz, dy, dx = spacings3(spacing)
    cuda = method == "auto" and ux.device.type == "cuda"
    if (
        cuda
        and ux.ndim == 3
        and ux.shape == uy.shape == uz.shape
        and ux.dtype == uy.dtype == uz.dtype
        and vec.curl_fused_supported(scheme, *ux.shape, ux.dtype)
    ):
        return vec.curl_fused((ux, uy, uz), dz, dy, dx, scheme)
    if cuda and uz.ndim >= 3 and pair.pair_supported(scheme, uz.shape[-2], uz.shape[-1], uz.dtype):
        duz_dx, duz_dy = pair.gradient_pair(uz, dy, dx, scheme)
    else:
        duz_dy = dfdy(uz, dy, scheme, method=method)
        duz_dx = dfdx(uz, dx, scheme, method=method)
    duy_dz = dfdz(uy, dz, scheme, method=method)
    dux_dz = dfdz(ux, dz, scheme, method=method)
    duy_dx = dfdx(uy, dx, scheme, method=method)
    dux_dy = dfdy(ux, dy, scheme, method=method)
    return (duz_dy - duy_dz, dux_dz - duz_dx, duy_dx - dux_dy)


def laplacian(
    f: torch.Tensor,
    spacing,
    scheme: CompactScheme = SCHEME4_D2,
    *,
    method: str = "auto",
) -> torch.Tensor:
    """Laplacian of ``[..., nz, ny, nx]`` by compact second derivatives;
    ``spacing`` is a scalar or (dz, dy, dx).

    On ``"auto"`` with a CUDA float32 field of 3 or more axes it takes the
    JAX function's TPU routes, which share reads between the axes:

    * (nz, ny, nx) and a periodic d2 scheme (``adv_lap.lap_rhs_supported``):
      K9 forms ``B_z f + T_z (d2x + d2y)`` and K2's solve along z turns it
      into the Laplacian (``leading_solve(lap_rhs(f))``);
    * otherwise (nz, ny, nx): K8 forms ``s = d2x + d2y`` and K2 adds d2z to
      it in its ``acc`` epilogue;
    * more axes: K8, plus ``d2fdz2``.

    Otherwise it is the sum of the three single-axis second derivatives.
    """
    scheme = _d2_scheme(scheme)
    dz, dy, dx = spacings3(spacing)
    if (
        method == "auto"
        and f.device.type == "cuda"
        and f.ndim >= 3
        and pair.d2_sum_supported(scheme, f.shape[-2], f.shape[-1], f.dtype)
    ):
        if f.ndim == 3 and adv_lap.lap_rhs_supported(scheme, *f.shape, f.dtype):
            return strided.leading_solve(adv_lap.lap_rhs(f, dz, dy, dx, scheme), scheme)
        s = pair.d2_pair_sum(f, dy, dx, scheme)
        if f.ndim == 3:
            return strided.strided_derivative(f, dz, scheme, 0, acc=s)
        return s + d2fdz2(f, dz, scheme, method=method)
    return (
        d2fdx2(f, dx, scheme, method=method)
        + d2fdy2(f, dy, scheme, method=method)
        + d2fdz2(f, dz, scheme, method=method)
    )
