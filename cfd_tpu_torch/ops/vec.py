"""The fused divergence: kernel K6 and K2's solve.

The port of ``cfd_tpu/ops/pallas_vec.py`` (``div_rhs`` and
``divergence_fused``; curl is not ported yet). With T_z and B_z the z
operators of a periodic d1 scheme, the solution of

    T_z y = B_z uz / dz + T_z (D1x ux + D1y uy)

is y = D1z uz + D1x ux + D1y uy = div u. ``div_rhs`` forms the right-hand
side from one read of each component; ``divergence_fused`` solves it along
z with ``strided.leading_solve``. On CUDA float32 tensors ``div_rhs``
launches ``div_rhs`` (``csrc/div_rhs.cu``); on CPU tensors it returns
``div_rhs_ref``, the plain PyTorch version, which applies the dense
operators. Periodic d1 schemes only, as in the JAX package.

``LAUNCHES`` counts calls that launched K6 (its two phases count once);
nothing but the launch adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from ..schemes import CompactScheme
from . import _native, strided
from .adv_lap import device_z_tables
from .dense import dense_apply, dense_derivative

__all__ = ["LAUNCHES", "div_rhs", "div_rhs_ref", "divergence_fused"]

LAUNCHES = 0


def _check(u, scheme: CompactScheme) -> None:
    if scheme.derivative_order != 1 or not scheme.periodic:
        raise ValueError(f"div_rhs: {scheme.name!r} is not a periodic d1 scheme")
    shapes = {tuple(c.shape) for c in u}
    if len(u) != 3 or len(shapes) != 1 or u[0].ndim != 3:
        raise ValueError(
            f"div_rhs needs three equal-shape (nz, ny, nx) fields, got {sorted(shapes)}"
        )


def div_rhs_ref(ux, uy, uz, dz, dy, dx, scheme: CompactScheme):
    """The plain PyTorch version: ``B_z uz / dz + T_z (D1x ux + D1y uy)``
    from the dense operators."""
    _check((ux, uy, uz), scheme)
    s = dense_derivative(ux, dx, scheme, -1) + dense_derivative(uy, dy, scheme, -2)
    return dense_apply("rhs", uz, scheme, 0, float(dz)) + dense_apply("lhs", s, scheme, 0)


def div_rhs(ux, uy, uz, dz, dy, dx, scheme: CompactScheme):
    """``B_z uz / dz + T_z (D1x ux + D1y uy)`` of (nz, ny, nx) fields.

    Solving it along z with the scheme's LHS (``strided.leading_solve``)
    gives div u. CUDA tensors must be float32 and contiguous and run the
    kernel; a launch failure raises. CPU tensors take ``div_rhs_ref``.
    """
    global LAUNCHES
    _check((ux, uy, uz), scheme)
    if ux.device.type == "cpu":
        return div_rhs_ref(ux, uy, uz, dz, dy, dx, scheme)
    _native.check_operands("div_rhs", ux, uy, uz)
    nz, ny, nx = ux.shape
    dev = ux.device
    bt, tt = device_z_tables(scheme, nz, float(dz), dev)
    cy, ty = _native.launch_tables(scheme, ny, float(dy), dev)
    cx, tx = _native.launch_tables(scheme, nx, float(dx), dev)
    r = torch.empty_like(ux)
    with torch.cuda.device(dev):
        err = _native.library().cfd_div_rhs(
            ux.data_ptr(), uy.data_ptr(), uz.data_ptr(), r.data_ptr(),
            ty.data_ptr(), tx.data_ptr(), bt.data_ptr(), tt.data_ptr(),
            ctypes.byref(cy), ctypes.byref(cx), nz, scheme.stencil_width,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "div_rhs")
    LAUNCHES += 1
    return r


def divergence_fused(u, dz, dy, dx, scheme: CompactScheme):
    """div u of ``u = (ux, uy, uz)``, (nz, ny, nx) each: ``div_rhs`` and
    one z solve (K6 then K2 on the card)."""
    ux, uy, uz = u
    return strided.leading_solve(div_rhs(ux, uy, uz, dz, dy, dx, scheme), scheme)
