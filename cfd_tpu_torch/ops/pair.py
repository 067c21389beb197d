"""Both xy derivatives of one field in one call: kernels K7 (``gradient_pair``),
K8 (``d2_pair_sum``) and K13 (``advection_pair``), and the projection's x/y
update (``pair_subtract``).

The port of ``cfd_tpu/ops/pallas_pair.py``:

* ``gradient_pair``: ``(df/dx, df/dy)`` of a (..., ny, nx) field for a
  first-derivative scheme (its Pallas kernel ``_pair_kernel``). On a CUDA
  float32 tensor it launches K7 (``csrc/pair.cu``), whose blocks walk y as
  K2 does or stage x-lines as K1 does, interleaved in one launch.
  ``derivatives.gradient`` takes it for x and y, and ``derivatives.curl``
  for uz on its non-fused route.
* ``d2_pair_sum``: ``d2f/dx2 + d2f/dy2`` in one output for a second-
  derivative scheme (``_d2_sum_kernel``). On a CUDA float32 tensor it
  launches K8 (``csrc/d2_sum.cu``, a weighted family of
  ``csrc/xy_phase.cuh``). ``derivatives.laplacian`` takes it for a
  non-periodic d2 scheme, with z through K2's ``acc`` epilogue.
* ``advection_pair``: ``ux * df/dx + uy * df/dy`` for a first-derivative
  scheme (``_adv_pair_kernel``), the stepwise head of the fused RK3
  substep (``ops/fused_step.py``) where K3 does not fit. On a CUDA float32
  tensor it launches K13 (``csrc/adv_pair.cu``, an advection family of
  ``csrc/xy_phase.cuh`` alone), whose x phase runs K1's sub-block chains
  (``csrc/line_chains.cuh``) on the lines ``lane.line_nb`` cuts.
* ``pair_subtract``: the x and y components of ``u - grad(phi)`` in
  ``ops/poisson.project``'s compact form (``_pair_sub_kernel``). On a CUDA
  float32 tensor it launches K1 (``csrc/compact_lane.cu``) and K2
  (``csrc/compact_strided.cu``) with their ``acc`` epilogue and a negative
  spacing, ``ax + D(-dx) phi``, so neither derivative of phi makes a round
  trip through memory: 3 reads and 2 writes in all, as the TPU kernel.

``pair_supported``, ``d2_sum_supported`` and ``adv_pair_supported`` say
where ``"auto"`` and the fused substep take K7, K8 and K13, as their JAX
namesakes do on the TPU: the scheme's derivative order
and float32; the TPU's conditions of a plane in VMEM with axes that are
multiples of 128 become the card's (``_native.xy_planes_fit``): lines no
shorter than the scheme, and an x-line within an x block's 48 KB of shared
memory. On a CPU tensor each function returns its plain PyTorch
version (``*_ref``), from the dense operators.

``GRADIENT_LAUNCHES``, ``D2_SUM_LAUNCHES``, ``ADV_PAIR_LAUNCHES`` and
``LAUNCHES`` count calls that launched K7, K8, K13 and the
``pair_subtract`` kernels (K8's and K13's two phases, and
``pair_subtract``'s two launches, count once); nothing but a launch adds to
them.
"""

from __future__ import annotations

import ctypes

import torch

from ..schemes import CompactScheme
from . import _native, lane, strided
from .dense import dense_derivative

__all__ = [
    "GRADIENT_LAUNCHES",
    "D2_SUM_LAUNCHES",
    "ADV_PAIR_LAUNCHES",
    "LAUNCHES",
    "pair_supported",
    "d2_sum_supported",
    "adv_pair_supported",
    "gradient_pair",
    "gradient_pair_ref",
    "d2_pair_sum",
    "d2_pair_sum_ref",
    "advection_pair",
    "advection_pair_ref",
    "pair_subtract",
    "pair_subtract_ref",
]

GRADIENT_LAUNCHES = 0
D2_SUM_LAUNCHES = 0
ADV_PAIR_LAUNCHES = 0
LAUNCHES = 0


def pair_supported(scheme: CompactScheme, ny: int, nx: int, dtype) -> bool:
    """Whether K7 takes (..., ny, nx) fields of ``dtype`` for ``scheme``."""
    return (scheme.derivative_order == 1 and dtype == torch.float32
            and _native.xy_planes_fit(scheme, ny, nx))


def d2_sum_supported(scheme: CompactScheme, ny: int, nx: int, dtype) -> bool:
    """Whether K8 takes (..., ny, nx) fields of ``dtype`` for ``scheme``."""
    return (scheme.derivative_order == 2 and dtype == torch.float32
            and _native.xy_planes_fit(scheme, ny, nx))


def adv_pair_supported(scheme: CompactScheme, ny: int, nx: int, dtype) -> bool:
    """Whether ``"auto"`` and the fused substep take K13 for (..., ny, nx)
    fields of ``dtype`` and ``scheme``: K7's conditions (one staged x-line
    within 48 KB, nx <= 12278), as the JAX package routes it; the kernel's
    chained x phase also takes longer lines."""
    return pair_supported(scheme, ny, nx, dtype)


def _check_field(who: str, f, scheme: CompactScheme, order: int) -> None:
    if scheme.derivative_order != order:
        kind = {1: "first", 2: "second"}[order]
        raise ValueError(f"{who}: {scheme.name!r} is not a {kind}-derivative scheme")
    if f.ndim < 2:
        raise ValueError(f"{who} needs (..., ny, nx) fields, got {tuple(f.shape)}")


def gradient_pair_ref(f, dy, dx, scheme: CompactScheme):
    """The plain PyTorch version: the dense operators along x and y."""
    _check_field("gradient_pair", f, scheme, 1)
    return dense_derivative(f, dx, scheme, -1), dense_derivative(f, dy, scheme, -2)


def _xy_tables(f, dy, dx, scheme):
    ny, nx = f.shape[-2:]
    cx, tx = _native.launch_tables(scheme, nx, float(dx), f.device)
    cy, ty = _native.launch_tables(scheme, ny, float(dy), f.device)
    return cx, tx, cy, ty, f.numel() // (ny * nx)


def gradient_pair(f, dy, dx, scheme: CompactScheme):
    """``(df/dx, df/dy)`` of ``f`` (..., ny, nx) in one launch.

    ``scheme`` is a first-derivative scheme. CUDA tensors must be float32
    and contiguous and run the kernel; an x-line past 48 KB and a launch
    failure raise. CPU tensors take ``gradient_pair_ref``.
    """
    global GRADIENT_LAUNCHES
    _check_field("gradient_pair", f, scheme, 1)
    if f.device.type == "cpu":
        return gradient_pair_ref(f, dy, dx, scheme)
    _native.check_operands("gradient_pair", f)
    cx, tx, cy, ty, planes = _xy_tables(f, dy, dx, scheme)
    gx, gy = torch.empty_like(f), torch.empty_like(f)
    if planes == 0:
        return gx, gy
    with torch.cuda.device(f.device):
        err = _native.library().cfd_gradient_pair(
            f.data_ptr(), gx.data_ptr(), gy.data_ptr(), tx.data_ptr(), ty.data_ptr(),
            ctypes.byref(cx), ctypes.byref(cy), planes,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "gradient_pair")
    GRADIENT_LAUNCHES += 1
    return gx, gy


def d2_pair_sum_ref(f, dy, dx, scheme: CompactScheme):
    """The plain PyTorch version: the dense operators along x and y, summed."""
    _check_field("d2_pair_sum", f, scheme, 2)
    return dense_derivative(f, dx, scheme, -1) + dense_derivative(f, dy, scheme, -2)


def d2_pair_sum(f, dy, dx, scheme: CompactScheme):
    """``d2f/dx2 + d2f/dy2`` of ``f`` (..., ny, nx) in one call.

    ``scheme`` is a second-derivative scheme, periodic or not. CUDA tensors
    must be float32 and contiguous and run the kernel; an x-line past 48 KB
    and a launch failure raise. CPU tensors take ``d2_pair_sum_ref``.
    """
    global D2_SUM_LAUNCHES
    _check_field("d2_pair_sum", f, scheme, 2)
    if f.device.type == "cpu":
        return d2_pair_sum_ref(f, dy, dx, scheme)
    _native.check_operands("d2_sum", f)
    cx, tx, cy, ty, planes = _xy_tables(f, dy, dx, scheme)
    s = torch.empty_like(f)
    if planes == 0:
        return s
    with torch.cuda.device(f.device):
        err = _native.library().cfd_d2_sum(
            f.data_ptr(), s.data_ptr(), ty.data_ptr(), tx.data_ptr(),
            ctypes.byref(cy), ctypes.byref(cx), planes,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "d2_sum")
    D2_SUM_LAUNCHES += 1
    return s


def _check_adv(f, ux, uy, scheme: CompactScheme) -> None:
    _check_field("advection_pair", f, scheme, 1)
    if ux.shape != f.shape or uy.shape != f.shape:
        raise ValueError(
            f"velocity shapes {tuple(ux.shape)}/{tuple(uy.shape)} != field shape {tuple(f.shape)}"
        )


def advection_pair_ref(f, ux, uy, dy, dx, scheme: CompactScheme):
    """The plain PyTorch version: the dense operators along x and y, then
    ``ux * fx + uy * fy``."""
    _check_adv(f, ux, uy, scheme)
    return ux * dense_derivative(f, dx, scheme, -1) + uy * dense_derivative(f, dy, scheme, -2)


def advection_pair(f, ux, uy, dy, dx, scheme: CompactScheme):
    """``ux * df/dx + uy * df/dy`` of ``f`` (..., ny, nx) in one call.

    ``scheme`` is a first-derivative scheme, periodic or not. CUDA tensors
    must be float32 and contiguous and run the kernel; an x-line past one
    block's opted-in shared memory and a launch failure raise. CPU tensors
    take ``advection_pair_ref``.
    """
    global ADV_PAIR_LAUNCHES
    _check_adv(f, ux, uy, scheme)
    if f.device.type == "cpu":
        return advection_pair_ref(f, ux, uy, dy, dx, scheme)
    _native.check_operands("adv_pair", f, ux, uy)
    ny, nx = f.shape[-2:]
    cy, ty = _native.launch_tables(scheme, ny, float(dy), f.device)
    nb = lane.line_nb(nx)
    cx, chx, h, win = lane._chain_launch_tables(scheme, nx, nb, float(dx), f.device)
    planes = f.numel() // (ny * nx)
    out = torch.empty_like(f)
    if planes == 0:
        return out
    with torch.cuda.device(f.device):
        err = _native.library().cfd_adv_pair(
            f.data_ptr(), ux.data_ptr(), uy.data_ptr(), out.data_ptr(), ty.data_ptr(),
            chx.data_ptr(), ctypes.byref(cy), ctypes.byref(cx), planes, nb, h, win,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "adv_pair")
    ADV_PAIR_LAUNCHES += 1
    return out


def _check(f, ax, ay, scheme: CompactScheme) -> None:
    _check_field("pair_subtract", f, scheme, 1)
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
