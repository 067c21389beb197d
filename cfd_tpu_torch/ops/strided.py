"""Compact derivative along any strided axis (d/dy, d/dz and their second
derivatives), its fused epilogues, and the bare tridiagonal solve: kernel K2.

The port of ``cfd_tpu/ops/pallas_sublane.py`` and
``cfd_tpu/ops/pallas_leading.py``. The field is viewed as
``(outer, n, inner)`` with the line along the middle axis: for a
``(nz, ny, nx)`` field, y is ``(nz, ny, nx)`` and z is ``(1, nz, ny*nx)``.
On a CUDA float32 tensor ``strided_derivative`` launches
``compact_strided`` (``csrc/compact_strided.cu``), which replaces
``_sublane_kernel`` (first derivatives), ``_sublane_fold_kernel`` (second
derivatives and filters) and ``_leading_kernel`` in its plain mode (every
scheme, filters with no spacing scale) and its epilogue modes:

* ``acc``: ``f' + acc`` (with a negative spacing, the projection's
  ``uz - dphi/dz``);
* ``mul``: ``mul * f' + acc`` (the advection term ``uz * fz + axy``);
* ``solve_only``: ``leading_solve`` solves ``T x = r`` for a right-hand side
  that is already formed (the second half of the fused divergence);
* ``rk``: ``rk3_solve_update`` solves ``lap = T^{-1} r`` for the
  Laplacian's z right-hand side r and emits the Williamson RK3 update
  ``q' = a q + dt (nu lap - adv)``, ``f' = fin + b q'`` from its backward
  sweep (``pallas_leading.rk3_solve_update``, ``_leading_kernel(rk=True)``):
  the stepwise tail of the fused substep where K4 is not taken.

On a CPU tensor each function returns its plain PyTorch version
(``*_ref``).

``LAUNCHES`` counts kernel launches, whatever the mode, and
``MODE_LAUNCHES`` the same launches by mode (a filter's plain-mode launch
is ``"filter"``); nothing but a launch adds to them. ``launch`` is the bare
launch, for ``ops/pair.py``, which counts its own calls.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..schemes import CompactScheme
from . import _native
from .dense import dense_apply, dense_derivative

__all__ = [
    "LAUNCHES",
    "MODE_LAUNCHES",
    "launch",
    "strided_derivative",
    "strided_derivative_ref",
    "leading_solve",
    "leading_solve_ref",
    "rk3_solve_update",
    "rk3_solve_update_ref",
]

LAUNCHES = 0
MODE_LAUNCHES = {"derivative": 0, "filter": 0, "acc": 0, "mul": 0, "solve": 0, "rk": 0}


def strided_derivative_ref(
    f: torch.Tensor, dx, scheme: CompactScheme, axis: int, *, acc=None, mul=None
) -> torch.Tensor:
    """The plain PyTorch version: the dense operator along ``axis``, then
    ``mul * f' + acc``."""
    out = dense_derivative(f, dx, scheme, axis)
    if mul is not None:
        out = mul * out
    return out + acc if acc is not None else out


def strided_derivative(
    f: torch.Tensor, dx, scheme: CompactScheme, axis: int, *, acc=None, mul=None
) -> torch.Tensor:
    """Compact first or second derivative, or filter, of ``f`` along
    ``axis``, any axis but the last, as ``mul * f' + acc`` where given (each
    of f's shape).

    CUDA tensors must be float32 and contiguous and run the kernel, with
    ``mul`` and ``acc`` applied by its final store; a line too short for the
    scheme and a launch failure raise. CPU tensors take
    ``strided_derivative_ref``.
    """
    global LAUNCHES
    _native.check_order(scheme)
    axis = axis % f.ndim
    if axis == f.ndim - 1:
        raise ValueError("the last axis is contiguous: use lane_derivative")
    for name, a in (("acc", acc), ("mul", mul)):
        if a is not None and a.shape != f.shape:
            raise ValueError(f"{name} shape {tuple(a.shape)} != field shape {tuple(f.shape)}")
    if f.device.type == "cpu":
        return strided_derivative_ref(f, dx, scheme, axis, acc=acc, mul=mul)
    out = launch(f, dx, scheme, axis, acc=acc, mul=mul)
    plain = "filter" if scheme.derivative_order == 0 else "derivative"
    mode = "mul" if mul is not None else ("acc" if acc is not None else plain)
    LAUNCHES += 1
    MODE_LAUNCHES[mode] += 1
    return out


def leading_solve_ref(rhs: torch.Tensor, scheme: CompactScheme) -> torch.Tensor:
    """The plain PyTorch version: T^{-1} applied densely along axis 0."""
    return dense_apply("lhs_inverse", rhs, scheme, 0)


def leading_solve(rhs: torch.Tensor, scheme: CompactScheme) -> torch.Tensor:
    """Solve ``T x = rhs`` along axis 0 with the scheme's LHS operator.

    The counterpart of ``pallas_leading.leading_solve``: K2 with its RHS
    stencil replaced by the identity (no closure rows, no wrap; a periodic
    line keeps its Sherman–Morrison term). CUDA tensors run the kernel; CPU
    tensors take ``leading_solve_ref``.
    """
    global LAUNCHES
    _native.check_order(scheme)
    if rhs.ndim == 0:
        raise ValueError("leading_solve needs at least one axis")
    if rhs.device.type == "cpu":
        return leading_solve_ref(rhs, scheme)
    out = launch(rhs, 1.0, scheme, 0, solve_only=True)
    LAUNCHES += 1
    MODE_LAUNCHES["solve"] += 1
    return out


def _check_rk(r, adv, q, fin, scheme: CompactScheme) -> None:
    if scheme.derivative_order != 2:
        raise ValueError(f"rk3_solve_update: {scheme.name!r} is not a second-derivative scheme")
    if r.ndim != 3:
        raise ValueError(f"rk3_solve_update needs (nz, ny, nx) fields, got {tuple(r.shape)}")
    for name, arr in (("adv", adv), ("fin", fin)) + ((("q", q),) if q is not None else ()):
        if arr.shape != r.shape:
            raise ValueError(f"{name} shape {tuple(arr.shape)} != rhs shape {tuple(r.shape)}")


def rk3_solve_update_ref(r, adv, q, fin, scheme: CompactScheme, *, a, b, dt, nu):
    """The plain PyTorch version: the dense ``T^{-1}`` along z, then the
    update."""
    _check_rk(r, adv, q, fin, scheme)
    lap = dense_apply("lhs_inverse", r, scheme, 0)
    qn = (dt * nu) * lap - dt * adv
    if q is not None:
        qn = qn + a * q
    return qn, fin + b * qn


def rk3_solve_update(r, adv, q, fin, scheme: CompactScheme, *, a, b, dt, nu):
    """``(q', f')`` of one Williamson RK3 substep from the Laplacian's z
    right-hand side ``r`` (``adv_lap.lap_rhs``), the advection term ``adv``
    and the substep's input ``fin``, all (nz, ny, nx):

        lap = T_z^{-1} r,   q' = a q + dt (nu lap - adv),   f' = fin + b q'

    with ``T_z`` the d2 ``scheme``'s LHS along z; ``q=None`` encodes the
    first substep (a == 0). CUDA tensors must be float32 and contiguous and
    run K2 in its rk mode; a launch failure raises. CPU tensors take
    ``rk3_solve_update_ref``.
    """
    global LAUNCHES
    _check_rk(r, adv, q, fin, scheme)
    if r.device.type == "cpu":
        return rk3_solve_update_ref(r, adv, q, fin, scheme, a=a, b=b, dt=dt, nu=nu)
    _native.check_operands("compact_strided", r, adv, fin, *((q,) if q is not None else ()))
    n = r.shape[0]
    coef, tab = _native.launch_tables(scheme, n, 1.0, r.device)  # only its LHS is read
    qout, fout = torch.empty_like(r), torch.empty_like(r)
    if r.numel() == 0:
        return qout, fout
    with torch.cuda.device(r.device):
        err = _native.library().cfd_strided_rk(
            r.data_ptr(), adv.data_ptr(), q.data_ptr() if q is not None else None,
            fin.data_ptr(), qout.data_ptr(), fout.data_ptr(), tab.data_ptr(),
            ctypes.byref(coef), float(a), float(b), float(dt), float(dt) * float(nu),
            1, r.numel() // n, torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "compact_strided")
    LAUNCHES += 1
    MODE_LAUNCHES["rk"] += 1
    return qout, fout


def launch(f, dx, scheme: CompactScheme, axis: int, *, acc=None, mul=None,
           solve_only: bool = False) -> torch.Tensor:
    """One launch of the kernel on a CUDA tensor, counted by the caller."""
    extras = [a for a in (mul, acc) if a is not None]
    _native.check_operands("compact_strided", f, *extras)
    n = f.shape[axis]
    # solve_only reads only the LHS tables: the scale of dx is never used
    coef, tab = _native.launch_tables(scheme, n, float(dx), f.device)
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
            mul.data_ptr() if mul is not None else None,
            acc.data_ptr() if acc is not None else None,
            int(solve_only),
            outer,
            inner,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "compact_strided")
    return out
