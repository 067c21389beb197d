"""The z-work and update of one RK3 substep in one call: kernel K4.

The port of ``cfd_tpu/ops/pallas_megastep.py`` (``rk3_mega``, its Pallas
kernel ``_mega_kernel``). From f, the Laplacian's z right-hand side r and
the advection term's xy part axy (``ops/adv_lap.py``), it computes

    fz  = D1z f                 lap = T2z^{-1} r
    q'  = a q + dt (nu lap - (axy + uz fz))         (no q: a == 0)
    f'  = f + b q'

and returns ``(q', f')``; with ``write_q=False`` (the last substep, where q'
is dead) it returns ``(None, f')``. On a CUDA float32 tensor ``rk3_mega``
launches ``rk3_mega`` (``csrc/rk3_mega.cu``); on a CPU tensor it returns
``rk3_mega_ref``, the plain PyTorch version, which applies the dense
operators.

``rk3_mega_supported`` says where K4 is taken: it stages nothing in shared
memory, so its only conditions are float32 (nz, ny, nx) fields and a z line
that both schemes take. Where it is not, the fused substep's tail runs
stepwise (``ops/fused_step.py``: K2 with ``mul`` and ``acc``, then K2's
``rk`` mode).

``LAUNCHES`` counts kernel launches; nothing but the launch adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from ..schemes import CompactScheme
from . import _native
from .dense import dense_apply, dense_derivative

__all__ = ["LAUNCHES", "rk3_mega_supported", "rk3_mega", "rk3_mega_ref"]

LAUNCHES = 0


def rk3_mega_supported(scheme1: CompactScheme, scheme2: CompactScheme, shape, dtype) -> bool:
    """Whether K4 takes (nz, ny, nx) fields of ``dtype`` for the d1
    ``scheme1`` and the d2 ``scheme2``."""
    return (len(shape) == 3 and dtype == torch.float32
            and shape[0] >= max(scheme1.min_points(), scheme2.min_points()))


def _check(f, r, axy, uz, q, scheme1: CompactScheme, scheme2: CompactScheme) -> None:
    if scheme1.derivative_order != 1:
        raise ValueError(f"rk3_mega: {scheme1.name!r} is not a first-derivative scheme")
    if scheme2.derivative_order != 2:
        raise ValueError(f"rk3_mega: {scheme2.name!r} is not a second-derivative scheme")
    if f.ndim != 3:
        raise ValueError(f"rk3_mega needs (nz, ny, nx) fields, got {tuple(f.shape)}")
    named = (("r", r), ("axy", axy), ("uz", uz)) + ((("q", q),) if q is not None else ())
    for name, arr in named:
        if arr.shape != f.shape:
            raise ValueError(f"{name} shape {tuple(arr.shape)} != field shape {tuple(f.shape)}")


def rk3_mega_ref(f, r, axy, uz, q, scheme1, scheme2, dz, *, a, b, dt, nu, write_q=True):
    """The plain PyTorch version: dense D1z and T2z^{-1}, then the update."""
    _check(f, r, axy, uz, q, scheme1, scheme2)
    fz = dense_derivative(f, dz, scheme1, 0)
    lap = dense_apply("lhs_inverse", r, scheme2, 0)
    qn = (dt * nu) * lap - dt * (axy + uz * fz)
    if q is not None:
        qn = qn + a * q
    return (qn if write_q else None), f + b * qn


def rk3_mega(f, r, axy, uz, q, scheme1: CompactScheme, scheme2: CompactScheme, dz,
             *, a, b, dt, nu, write_q: bool = True):
    """dfdz, the Laplacian's z solve and the RK3 update of one substep.

    All arrays (nz, ny, nx); ``q=None`` encodes the first substep.
    ``scheme1`` is the d1 scheme, ``scheme2`` the d2 scheme whose LHS
    solves r. CUDA tensors must be float32 and contiguous and run the
    kernel; a launch failure raises. CPU tensors take ``rk3_mega_ref``.
    """
    global LAUNCHES
    _check(f, r, axy, uz, q, scheme1, scheme2)
    if f.device.type == "cpu":
        return rk3_mega_ref(f, r, axy, uz, q, scheme1, scheme2, dz,
                            a=a, b=b, dt=dt, nu=nu, write_q=write_q)
    _native.check_operands("rk3_mega", f, r, axy, uz, *((q,) if q is not None else ()))
    nz = f.shape[0]
    dev = f.device
    c1, t1 = _native.launch_tables(scheme1, nz, float(dz), dev)
    # the d2 family's RHS is r itself: only its LHS tables are read
    c2, t2 = _native.launch_tables(scheme2, nz, 1.0, dev)
    fout = torch.empty_like(f)
    qout = torch.empty_like(f)  # q', or the d2 sweep's scratch when write_q is False
    if f.numel() == 0:
        return (qout if write_q else None), fout
    with torch.cuda.device(dev):
        err = _native.library().cfd_rk3_mega(
            f.data_ptr(), r.data_ptr(), axy.data_ptr(), uz.data_ptr(),
            q.data_ptr() if q is not None else None,
            qout.data_ptr(), fout.data_ptr(), t1.data_ptr(), t2.data_ptr(),
            ctypes.byref(c1), ctypes.byref(c2),
            float(a), float(b), float(dt), float(dt) * float(nu), int(write_q),
            f.numel() // nz,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "rk3_mega")
    LAUNCHES += 1
    return (qout if write_q else None), fout
