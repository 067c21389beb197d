"""The advection term in x and y and the Laplacian's z right-hand side from
one call: kernel K3.

The port of the merged head of ``cfd_tpu/ops/pallas_lap.py``
(``adv_lap_rhs``, its Pallas kernel ``_adv_lap_kernel``, and the z tables
``_z_tables``). For a (nz, ny, nx) field f, a d1 scheme D1 and a periodic
d2 scheme D2 with z operators T_z (LHS) and B_z (RHS):

    axy = ux * D1x f + uy * D1y f
    r   = B_z f / dz**2 + T_z (D2x f + D2y f)

Solving ``T_z lap = r`` along z gives the Laplacian, since the xy operator
commutes with T_z (``ops/megastep.py`` does that solve). On a CUDA float32
tensor ``adv_lap_rhs`` launches ``adv_lap`` (``csrc/adv_lap.cu``); on a CPU
tensor it returns ``adv_lap_rhs_ref``, the plain PyTorch version, which
applies the dense operators.

``LAUNCHES`` counts calls that launched the kernel (its two phases count
once); nothing but the launch adds to it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..schemes import CompactScheme, lhs_bands, rhs_matrix
from . import _native
from .dense import dense_apply, dense_derivative

__all__ = ["LAUNCHES", "z_tables", "adv_lap_rhs", "adv_lap_rhs_ref"]

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def z_tables(scheme: CompactScheme, n: int):
    """(btab (n, 2W+1), ttab (n, 3)), float64, of a periodic scheme.

    btab[j, k+W] is the B_z coefficient of f[(j+k) mod n]; ttab[j, k+1]
    the T_z coefficient of s[(j+k) mod n] (the corner couplings of the
    periodic T are its wrapped off-diagonals). W == scheme.stencil_width:
    every row is the wrapped interior stencil.
    """
    if not scheme.periodic:
        raise ValueError(f"z_tables: scheme {scheme.name} is not periodic")
    B = rhs_matrix(scheme, n)
    W = scheme.stencil_width
    btab = np.zeros((n, 2 * W + 1), np.float64)
    for j in range(n):
        for c in np.nonzero(B[j])[0]:
            k = (c - j + n // 2) % n - n // 2
            btab[j, k + W] += B[j, c]
    dl, d, du = lhs_bands(scheme, n)
    ttab = np.stack([dl, d, du], axis=1)
    ttab[0, 0] = scheme.alpha  # row 0 couples s[n-1] (offset -1 wraps)
    ttab[-1, 2] = scheme.alpha  # row n-1 couples s[0]
    return btab, ttab


@functools.lru_cache(maxsize=16)
def _device_z_tables(scheme: CompactScheme, n: int, dz: float, device: torch.device):
    btab, ttab = z_tables(scheme, n)
    # the kernel forms B_z f from differences to f[p]: every row must
    # annihilate constants, as a derivative's does
    if np.abs(btab.sum(axis=1)).max() > 1e-12 * np.abs(btab).max():
        raise ValueError(f"adv_lap: B_z rows of {scheme.name} do not annihilate constants")
    bt = torch.as_tensor(btab / dz**2, dtype=torch.float32, device=device)
    tt = torch.as_tensor(ttab, dtype=torch.float32, device=device)
    return bt, tt


def _check(f, ux, uy, scheme1: CompactScheme, scheme2: CompactScheme) -> None:
    if scheme1.derivative_order != 1:
        raise ValueError(f"adv_lap_rhs: {scheme1.name!r} is not a first-derivative scheme")
    if scheme2.derivative_order != 2 or not scheme2.periodic:
        raise ValueError(f"adv_lap_rhs: {scheme2.name!r} is not a periodic d2 scheme")
    if f.ndim != 3:
        raise ValueError(f"adv_lap_rhs needs a 3-D (nz, ny, nx) field, got {tuple(f.shape)}")
    if ux.shape != f.shape or uy.shape != f.shape:
        raise ValueError(
            f"velocity shapes {tuple(ux.shape)}/{tuple(uy.shape)} != field shape {tuple(f.shape)}"
        )


def adv_lap_rhs_ref(f, ux, uy, dz, dy, dx, scheme1: CompactScheme, scheme2: CompactScheme):
    """The plain PyTorch version, from the dense operators:
    ``(ux*D1x f + uy*D1y f, B_z f/dz**2 + T_z(D2x f + D2y f))``."""
    _check(f, ux, uy, scheme1, scheme2)
    axy = ux * dense_derivative(f, dx, scheme1, -1) + uy * dense_derivative(f, dy, scheme1, -2)
    s = dense_derivative(f, dx, scheme2, -1) + dense_derivative(f, dy, scheme2, -2)
    r = dense_apply("rhs", f, scheme2, 0, float(dz) ** 2) + dense_apply("lhs", s, scheme2, 0)
    return axy, r


def adv_lap_rhs(f, ux, uy, dz, dy, dx, scheme1: CompactScheme, scheme2: CompactScheme):
    """``(ux*D1x f + uy*D1y f, B_z f/dz**2 + T_z(D2x f + D2y f))`` of a
    (nz, ny, nx) field, in one call.

    ``scheme1`` is the d1 scheme, ``scheme2`` a periodic d2 scheme. CUDA
    tensors must be float32 and contiguous and run the kernel; a launch
    failure raises. CPU tensors take ``adv_lap_rhs_ref``.
    """
    global LAUNCHES
    _check(f, ux, uy, scheme1, scheme2)
    if f.device.type == "cpu":
        return adv_lap_rhs_ref(f, ux, uy, dz, dy, dx, scheme1, scheme2)
    _native.check_operands("adv_lap", f, ux, uy)
    nz, ny, nx = f.shape
    dev = f.device
    bt, tt = _device_z_tables(scheme2, nz, float(dz), dev)
    c1y, t1y = _native.launch_tables(scheme1, ny, float(dy), dev)
    c2y, t2y = _native.launch_tables(scheme2, ny, float(dy), dev)
    c1x, t1x = _native.launch_tables(scheme1, nx, float(dx), dev)
    c2x, t2x = _native.launch_tables(scheme2, nx, float(dx), dev)
    axy = torch.empty_like(f)
    r = torch.empty_like(f)
    with torch.cuda.device(dev):
        err = _native.library().cfd_adv_lap(
            f.data_ptr(), ux.data_ptr(), uy.data_ptr(), axy.data_ptr(), r.data_ptr(),
            t1y.data_ptr(), t2y.data_ptr(), t1x.data_ptr(), t2x.data_ptr(),
            bt.data_ptr(), tt.data_ptr(),
            ctypes.byref(c1y), ctypes.byref(c2y), ctypes.byref(c1x), ctypes.byref(c2x),
            nz, scheme2.stencil_width,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "adv_lap")
    LAUNCHES += 1
    return axy, r
