"""The advection term in x and y and the Laplacian's z right-hand side from
one call: kernels K3 (one field) and K5 (a velocity's three components); and
the Laplacian's z right-hand side alone: kernel K9.

The port of ``cfd_tpu/ops/pallas_lap.py`` (``adv_lap_rhs``,
``adv_lap_rhs3`` and ``lap_rhs``, their Pallas kernels ``_adv_lap_kernel``,
``_adv_lap3_kernel`` and ``_lap_rhs_kernel``, and the z tables
``_z_tables``). For a (nz, ny, nx) field f, a d1 scheme D1 and a periodic
d2 scheme D2 with z operators T_z (LHS) and B_z (RHS):

    axy = ux * D1x f + uy * D1y f
    r   = B_z f / dz**2 + T_z (D2x f + D2y f)

Solving ``T_z lap = r`` along z gives the Laplacian, since the xy operator
commutes with T_z (``ops/megastep.py`` does that solve). ``adv_lap_rhs3``
computes both for each component u_i of a velocity, advected by u0 and u1,
in one call. ``lap_rhs`` computes r alone; ``derivatives.laplacian`` on a
periodic d2 scheme is ``strided.leading_solve(lap_rhs(f))``, and
``lap_rhs_supported`` says where ``"auto"`` takes that route, as its JAX
namesake does on the TPU (a periodic d2 scheme, float32, nz of at least the
z stencil; the TPU's VMEM slab condition becomes the card's
``_native.xy_planes_fit``). On CUDA float32 tensors ``adv_lap_rhs`` launches
``adv_lap`` (``csrc/adv_lap.cu``), ``adv_lap_rhs3`` launches ``adv_lap3``
(``csrc/adv_lap3.cu``) and ``lap_rhs`` launches ``lap_rhs``
(``csrc/lap_rhs.cu``); on CPU tensors they return ``adv_lap_rhs_ref``,
``adv_lap_rhs3_ref`` and ``lap_rhs_ref``, the plain PyTorch versions, which
apply the dense operators.

K3's x phase, and K5's for each component, stages two x-lines a line (f
and T_z f) from one read of f and solves them in K1's sub-block chains
(``csrc/line_chains.cuh``), the d1 and the d2 scheme's chain tables side
by side: K3 is K5's launch for one field. The chained launch takes lines
past 48 KB a block, but ``adv_lap_fits`` and ``adv_lap3_fits`` keep the
JAX package's limit of two staged lines within 48 KB (nx <= 6134), as its
routing has it; the fused substep (``ops/fused_step.py``) decides its head
by them. K9's x phase runs the same chains on T_z f. The chains are those
``lane.line_nb`` cuts, on the chain tables ``lane`` caches for K1.

``LAUNCHES``, ``LAUNCHES3`` and ``LAP_LAUNCHES`` count calls that launched
K3, K5 and K9 (each kernel's two phases count once); nothing but the launch
adds to them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..schemes import CompactScheme, lhs_bands, rhs_matrix
from . import _native, lane
from .dense import dense_apply, dense_derivative

__all__ = [
    "LAUNCHES",
    "LAUNCHES3",
    "z_tables",
    "device_z_tables",
    "adv_lap_fits",
    "adv_lap3_fits",
    "adv_lap_rhs",
    "adv_lap_rhs_ref",
    "adv_lap_rhs3",
    "adv_lap_rhs3_ref",
    "LAP_LAUNCHES",
    "lap_rhs_supported",
    "lap_rhs",
    "lap_rhs_ref",
]

LAUNCHES = 0
LAUNCHES3 = 0
LAP_LAUNCHES = 0


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
def device_z_tables(scheme: CompactScheme, n: int, dz: float, device: torch.device):
    """The kernels' float32 z tables on ``device``: (B_z / dz**order, T_z)."""
    btab, ttab = z_tables(scheme, n)
    # the kernels form B_z f from differences to f[p]: every row must
    # annihilate constants, as a derivative's does
    if np.abs(btab.sum(axis=1)).max() > 1e-12 * np.abs(btab).max():
        raise ValueError(f"{scheme.name}: B_z rows do not annihilate constants")
    bt = torch.as_tensor(btab / dz**scheme.derivative_order, dtype=torch.float32, device=device)
    tt = torch.as_tensor(ttab, dtype=torch.float32, device=device)
    return bt, tt


def adv_lap_fits(shape) -> bool:
    """Whether the fused substep takes K3 for (nz, ny, nx) fields: two
    staged lines (the advection and the Laplacian family's) within an x
    block's 48 KB, nx <= 6134, as the JAX package routes K3 by the VMEM
    they need. K3's chained x phase also takes longer lines."""
    return _native.x_lines_fit(shape[-1], tiles=2)


def adv_lap3_fits(shape) -> bool:
    """Whether the fused substep takes K5 for (nz, ny, nx) fields: the
    x-lines the substep takes K3 for (``adv_lap_fits``), as the JAX package
    routes K5 by the VMEM its two staged lines a component need. K5's
    chained x phase also takes longer lines."""
    return _native.x_lines_fit(shape[-1], tiles=2)


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


def _pair_tables(shape, dz, dy, dx, scheme1, scheme2, dev):
    """The table arguments of K3 and K5 (``cfd_adv_lap``, ``cfd_adv_lap3``):
    the two schemes' line tables along y, their chain tables along x for
    ``lane.line_nb(nx)`` sub-blocks, the z tables, the four Coefs, nz, W,
    nb and each chain table's reduced window."""
    nz, ny, nx = shape
    bt, tt = device_z_tables(scheme2, nz, float(dz), dev)
    c1y, t1y = _native.launch_tables(scheme1, ny, float(dy), dev)
    c2y, t2y = _native.launch_tables(scheme2, ny, float(dy), dev)
    nb = lane.line_nb(nx)
    c1x, ch1, h1, win1 = lane._chain_launch_tables(scheme1, nx, nb, float(dx), dev)
    c2x, ch2, h2, win2 = lane._chain_launch_tables(scheme2, nx, nb, float(dx), dev)
    return (
        t1y.data_ptr(), t2y.data_ptr(), ch1.data_ptr(), ch2.data_ptr(),
        bt.data_ptr(), tt.data_ptr(),
        ctypes.byref(c1y), ctypes.byref(c2y), ctypes.byref(c1x), ctypes.byref(c2x),
        nz, scheme2.stencil_width, nb, h1, win1, h2, win2,
    )


def adv_lap_rhs(f, ux, uy, dz, dy, dx, scheme1: CompactScheme, scheme2: CompactScheme):
    """``(ux*D1x f + uy*D1y f, B_z f/dz**2 + T_z(D2x f + D2y f))`` of a
    (nz, ny, nx) field, in one call.

    ``scheme1`` is the d1 scheme, ``scheme2`` a periodic d2 scheme. CUDA
    tensors must be float32 and contiguous and run the kernel; a launch
    failure raises. CPU tensors take ``adv_lap_rhs_ref``.

    The kernel's x phase stages f once for both outputs and solves both in
    sub-block chains (``csrc/adv_lap.cu``), as ``adv_lap_rhs3`` does for
    each component.
    """
    global LAUNCHES
    _check(f, ux, uy, scheme1, scheme2)
    if f.device.type == "cpu":
        return adv_lap_rhs_ref(f, ux, uy, dz, dy, dx, scheme1, scheme2)
    _native.check_operands("adv_lap", f, ux, uy)
    axy = torch.empty_like(f)
    r = torch.empty_like(f)
    with torch.cuda.device(f.device):
        err = _native.library().cfd_adv_lap(
            f.data_ptr(), ux.data_ptr(), uy.data_ptr(), axy.data_ptr(), r.data_ptr(),
            *_pair_tables(f.shape, dz, dy, dx, scheme1, scheme2, f.device),
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "adv_lap")
    LAUNCHES += 1
    return axy, r


def adv_lap_rhs3_ref(u, dz, dy, dx, scheme1: CompactScheme, scheme2: CompactScheme):
    """The plain PyTorch version: ``adv_lap_rhs_ref(u_i, u0, u1)`` for each
    component, as ``((axy0, axy1, axy2), (r0, r1, r2))``."""
    outs = [adv_lap_rhs_ref(c, u[0], u[1], dz, dy, dx, scheme1, scheme2) for c in u]
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


def adv_lap_rhs3(u, dz, dy, dx, scheme1: CompactScheme, scheme2: CompactScheme):
    """``adv_lap_rhs(u_i, u0, u1)`` for the three components of a velocity
    ``u = (u0, u1, u2)`` in one call: ``((axy0, axy1, axy2), (r0, r1, r2))``.

    The kernel's x phase stages each component once for both of its
    outputs and solves both in sub-block chains (``csrc/adv_lap3.cu``).
    CUDA tensors must be float32 and contiguous and run the kernel; a
    launch failure raises. CPU tensors take ``adv_lap_rhs3_ref``.
    """
    global LAUNCHES3
    if len(u) != 3:
        raise ValueError(f"adv_lap_rhs3 needs three components, got {len(u)}")
    u0, u1, u2 = u
    for c in (u0, u1, u2):
        _check(c, u0, u1, scheme1, scheme2)
    if u0.device.type == "cpu":
        return adv_lap_rhs3_ref(u, dz, dy, dx, scheme1, scheme2)
    _native.check_operands("adv_lap3", u0, u1, u2)
    axy = [torch.empty_like(u0) for _ in range(3)]
    r = [torch.empty_like(u0) for _ in range(3)]
    with torch.cuda.device(u0.device):
        err = _native.library().cfd_adv_lap3(
            u0.data_ptr(), u1.data_ptr(), u2.data_ptr(),
            *(a.data_ptr() for a in axy), *(a.data_ptr() for a in r),
            *_pair_tables(u0.shape, dz, dy, dx, scheme1, scheme2, u0.device),
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "adv_lap3")
    LAUNCHES3 += 1
    return tuple(axy), tuple(r)


def lap_rhs_supported(scheme: CompactScheme, nz: int, ny: int, nx: int, dtype) -> bool:
    """Whether K9 takes (nz, ny, nx) fields of ``dtype`` for ``scheme``."""
    return (
        scheme.derivative_order == 2
        and scheme.periodic
        and dtype == torch.float32
        and nz >= max(scheme.min_points(), 2 * scheme.stencil_width + 1)
        and _native.xy_planes_fit(scheme, ny, nx)
    )


def _check_lap(f, scheme: CompactScheme) -> None:
    if scheme.derivative_order != 2 or not scheme.periodic:
        raise ValueError(f"lap_rhs: {scheme.name!r} is not a periodic d2 scheme")
    if f.ndim != 3:
        raise ValueError(f"lap_rhs needs a 3-D (nz, ny, nx) field, got {tuple(f.shape)}")


def lap_rhs_ref(f, dz, dy, dx, scheme: CompactScheme):
    """The plain PyTorch version, from the dense operators:
    ``B_z f/dz**2 + T_z(D2x f + D2y f)``."""
    _check_lap(f, scheme)
    s = dense_derivative(f, dx, scheme, -1) + dense_derivative(f, dy, scheme, -2)
    return dense_apply("rhs", f, scheme, 0, float(dz) ** 2) + dense_apply("lhs", s, scheme, 0)


def lap_rhs(f, dz, dy, dx, scheme: CompactScheme):
    """``B_z f/dz**2 + T_z(D2x f + D2y f)`` of a (nz, ny, nx) field.

    Solving it along z with the scheme's LHS (``strided.leading_solve``)
    gives the compact-d2 Laplacian. ``scheme`` is a periodic d2 scheme. CUDA
    tensors must be float32 and contiguous and run the kernel; a launch
    failure raises. CPU tensors take ``lap_rhs_ref``.
    """
    global LAP_LAUNCHES
    _check_lap(f, scheme)
    if f.device.type == "cpu":
        return lap_rhs_ref(f, dz, dy, dx, scheme)
    _native.check_operands("lap_rhs", f)
    nz, ny, nx = f.shape
    dev = f.device
    bt, tt = device_z_tables(scheme, nz, float(dz), dev)
    cy, ty = _native.launch_tables(scheme, ny, float(dy), dev)
    nb = lane.line_nb(nx)
    cx, chx, h, win = lane._chain_launch_tables(scheme, nx, nb, float(dx), dev)
    r = torch.empty_like(f)
    with torch.cuda.device(dev):
        err = _native.library().cfd_lap_rhs(
            f.data_ptr(), r.data_ptr(), ty.data_ptr(), chx.data_ptr(), bt.data_ptr(),
            tt.data_ptr(), ctypes.byref(cy), ctypes.byref(cx), nz, scheme.stencil_width,
            nb, h, win, torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "lap_rhs")
    LAP_LAUNCHES += 1
    return r
