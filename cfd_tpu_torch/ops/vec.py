"""The fused divergence and curl: kernels K6 and K10, and K2's solve.

The port of ``cfd_tpu/ops/pallas_vec.py`` (``div_rhs``,
``divergence_fused``, ``curl_rhs``, ``curl_fused`` and their predicates).
With T_z and B_z the z operators of a periodic d1 scheme, the solution of

    T_z y = B_z uz / dz + T_z (D1x ux + D1y uy)

is y = D1z uz + D1x ux + D1y uy = div u. ``div_rhs`` forms the right-hand
side from one read of each component; ``divergence_fused`` solves it along
z with ``strided.leading_solve``. The curl's z component is z-local, and
each of the other two mixes one z-local and one z-coupled term:

    wz = D1x uy - D1y ux
    T_z wx = rA = T_z (D1y uz) - B_z uy / dz
    T_z wy = rB = B_z ux / dz - T_z (D1x uz)

``curl_rhs`` forms (wz, rA, rB) in one call and ``curl_fused`` solves rA
and rB along z. On CUDA float32 tensors ``div_rhs`` launches ``div_rhs``
(``csrc/div_rhs.cu``) and ``curl_rhs`` launches ``curl_rhs``
(``csrc/curl_rhs.cu``); on CPU tensors they return ``div_rhs_ref`` and
``curl_rhs_ref``, the plain PyTorch versions, which apply the dense
operators. K6's x phase runs K1's sub-block chains (``csrc/line_chains.cuh``)
on the lines ``lane.line_nb`` cuts and the chain table ``lane`` caches for
K1, as K9's does. Periodic d1 schemes only, as in the JAX package;
``div_fused_supported`` and ``curl_fused_supported`` say where ``"auto"``
takes the fused divergence and curl, as their JAX namesakes do on the TPU
(the TPU's VMEM slab condition becomes the card's
``_native.xy_planes_fit``).

``LAUNCHES`` and ``CURL_LAUNCHES`` count calls that launched K6 and K10
(each kernel's two phases count once); nothing but the launch adds to them.
"""

from __future__ import annotations

import ctypes

import torch

from ..schemes import CompactScheme
from . import _native, lane, strided
from .adv_lap import device_z_tables
from .dense import dense_apply, dense_derivative

__all__ = [
    "LAUNCHES",
    "CURL_LAUNCHES",
    "div_rhs",
    "div_rhs_ref",
    "divergence_fused",
    "div_fused_supported",
    "curl_fused_supported",
    "curl_rhs",
    "curl_rhs_ref",
    "curl_fused",
]

LAUNCHES = 0
CURL_LAUNCHES = 0


def _check(u, scheme: CompactScheme, who: str = "div_rhs") -> None:
    if scheme.derivative_order != 1 or not scheme.periodic:
        raise ValueError(f"{who}: {scheme.name!r} is not a periodic d1 scheme")
    shapes = {tuple(c.shape) for c in u}
    if len(u) != 3 or len(shapes) != 1 or u[0].ndim != 3:
        raise ValueError(
            f"{who} needs three equal-shape (nz, ny, nx) fields, got {sorted(shapes)}"
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
    nb = lane.line_nb(nx)
    cx, chx, h, win = lane._chain_launch_tables(scheme, nx, nb, float(dx), dev)
    r = torch.empty_like(ux)
    with torch.cuda.device(dev):
        err = _native.library().cfd_div_rhs(
            ux.data_ptr(), uy.data_ptr(), uz.data_ptr(), r.data_ptr(),
            ty.data_ptr(), chx.data_ptr(), bt.data_ptr(), tt.data_ptr(),
            ctypes.byref(cy), ctypes.byref(cx), nz, scheme.stencil_width, nb, h, win,
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


def _fused_supported(scheme: CompactScheme, nz: int, ny: int, nx: int, dtype) -> bool:
    return (
        scheme.derivative_order == 1
        and scheme.periodic
        and dtype == torch.float32
        and nz >= max(scheme.min_points(), 2 * scheme.stencil_width + 1)
        and _native.xy_planes_fit(scheme, ny, nx)
    )


def div_fused_supported(scheme: CompactScheme, nz: int, ny: int, nx: int, dtype) -> bool:
    """Whether ``divergence`` takes K6 and the z solve for (nz, ny, nx)
    fields of ``dtype`` and ``scheme``. The JAX routing: K6's chained x
    phase also takes longer lines."""
    return _fused_supported(scheme, nz, ny, nx, dtype)


def curl_fused_supported(scheme: CompactScheme, nz: int, ny: int, nx: int, dtype) -> bool:
    """Whether K10 and the two z solves take (nz, ny, nx) fields of
    ``dtype`` for ``scheme``."""
    return _fused_supported(scheme, nz, ny, nx, dtype)


def curl_rhs_ref(ux, uy, uz, dz, dy, dx, scheme: CompactScheme):
    """The plain PyTorch version, from the dense operators:
    ``(D1x uy - D1y ux, T_z D1y uz - B_z uy / dz, B_z ux / dz - T_z D1x uz)``."""
    _check((ux, uy, uz), scheme, "curl_rhs")
    wz = dense_derivative(uy, dx, scheme, -1) - dense_derivative(ux, dy, scheme, -2)
    ra = (dense_apply("lhs", dense_derivative(uz, dy, scheme, -2), scheme, 0)
          - dense_apply("rhs", uy, scheme, 0, float(dz)))
    rb = (dense_apply("rhs", ux, scheme, 0, float(dz))
          - dense_apply("lhs", dense_derivative(uz, dx, scheme, -1), scheme, 0))
    return wz, ra, rb


def curl_rhs(ux, uy, uz, dz, dy, dx, scheme: CompactScheme):
    """``(wz, rA, rB)`` of (nz, ny, nx) fields in one call (module doc).

    Solving rA and rB along z with the scheme's LHS
    (``strided.leading_solve``) gives wx and wy. CUDA tensors must be
    float32 and contiguous and run the kernel; a launch failure raises. CPU
    tensors take ``curl_rhs_ref``.
    """
    global CURL_LAUNCHES
    _check((ux, uy, uz), scheme, "curl_rhs")
    if ux.device.type == "cpu":
        return curl_rhs_ref(ux, uy, uz, dz, dy, dx, scheme)
    _native.check_operands("curl_rhs", ux, uy, uz)
    nz, ny, nx = ux.shape
    dev = ux.device
    bt, tt = device_z_tables(scheme, nz, float(dz), dev)
    cy, ty = _native.launch_tables(scheme, ny, float(dy), dev)
    cx, tx = _native.launch_tables(scheme, nx, float(dx), dev)
    wz, ra, rb = (torch.empty_like(ux) for _ in range(3))
    with torch.cuda.device(dev):
        err = _native.library().cfd_curl_rhs(
            ux.data_ptr(), uy.data_ptr(), uz.data_ptr(), wz.data_ptr(), ra.data_ptr(),
            rb.data_ptr(), ty.data_ptr(), tx.data_ptr(), bt.data_ptr(), tt.data_ptr(),
            ctypes.byref(cy), ctypes.byref(cx), nz, scheme.stencil_width,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "curl_rhs")
    CURL_LAUNCHES += 1
    return wz, ra, rb


def curl_fused(u, dz, dy, dx, scheme: CompactScheme):
    """curl u = (wx, wy, wz) of ``u = (ux, uy, uz)``, (nz, ny, nx) each:
    ``curl_rhs`` and two z solves (K10 then K2 twice on the card)."""
    ux, uy, uz = u
    wz, ra, rb = curl_rhs(ux, uy, uz, dz, dy, dx, scheme)
    return strided.leading_solve(ra, scheme), strided.leading_solve(rb, scheme), wz
