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

The kernel stages the z-lines of f and r of a block's columns in shared
memory and solves both families there in sub-block chains (``lane.line_nb``
of them a line, on ``lane.chain_table``), so ``rk3_mega_supported`` takes
float32 (nz, ny, nx) fields whose z-line both schemes take and whose two
tiles of one column fit the card's opt-in maximum of shared memory
(``tile_bytes`` against ``smem_limit``, which asks the device as the
kernel does: z-lines of up to about 29,000 points on an H100), as the JAX
predicate declines where its VMEM does not fit. Where it is not, the fused
substep's tail runs stepwise (``ops/fused_step.py``: K2 with ``mul`` and
``acc``, then K2's ``rk`` mode).

``LAUNCHES`` counts kernel launches; nothing but the launch adds to it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..schemes import CompactScheme
from . import _native, lane
from .dense import dense_apply, dense_derivative

__all__ = ["LAUNCHES", "tile_bytes", "smem_limit", "rk3_mega_supported", "rk3_mega", "rk3_mega_ref"]

LAUNCHES = 0


def tile_bytes(nz: int, nb: int, cols: int = 1) -> int:
    """The shared memory K4 stages for ``cols`` columns of ``nz`` rows in
    ``nb`` chains (``mega_bytes`` in ``csrc/rk3_mega.cu``): the tiles of f
    and r, and each family's 2 nb face slots a column."""
    return 4 * cols * (2 * nz + 4 * nb)


@functools.lru_cache(maxsize=None)
def _device_smem_limit(index: int) -> int:
    bytes_ = ctypes.c_int()
    with torch.cuda.device(index):
        err = _native.library().cfd_rk3_mega_smem_limit(ctypes.byref(bytes_))
    _native.check(err, "rk3_mega")
    return bytes_.value


def smem_limit(device) -> Optional[int]:
    """The shared memory a K4 block may take on ``device``, as the kernel
    itself asks it (``cfd_rk3_mega_smem_limit``: the device's opt-in
    maximum); None off the card, where the plain version stages nothing."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    return _device_smem_limit(device.index if device.index is not None
                              else torch.cuda.current_device())


def rk3_mega_supported(scheme1: CompactScheme, scheme2: CompactScheme, shape, dtype,
                       device=None) -> bool:
    """Whether K4 takes (nz, ny, nx) fields of ``dtype`` for the d1
    ``scheme1`` and the d2 ``scheme2``: a z-line both schemes take, whose
    two tiles of one column fit ``smem_limit(device)`` on the card."""
    if len(shape) != 3 or dtype != torch.float32:
        return False
    nz = shape[0]
    if nz < max(scheme1.min_points(), scheme2.min_points()):
        return False
    limit = smem_limit(device)
    return limit is None or tile_bytes(nz, lane.line_nb(nz)) <= limit


@functools.lru_cache(maxsize=None)
def _identity_rhs(n: int, periodic: bool, K: int) -> _native.Coef:
    """The Coef of family B's RHS rows, r itself: centre weight 1, no
    stencil, scale 1, no closure rows; ``periodic`` the d2 scheme's (the
    chains read it to close the ring), ``K`` family A's stencil width."""
    return _native.fill_coef({"n": n, "K": K, "periodic": int(periodic), "center": 1.0}, 1.0)


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
    nb = lane.line_nb(nz)
    dev = f.device
    c1, ch1, h1, win1 = lane._chain_launch_tables(scheme1, nz, nb, float(dz), dev)
    # family B's RHS is r itself: the d2 scheme's chain table, an identity Coef
    _, ch2, h2, win2 = lane._chain_launch_tables(scheme2, nz, nb, 1.0, dev)
    c2 = _identity_rhs(nz, scheme2.periodic, scheme1.stencil_width)
    fout = torch.empty_like(f)
    qout = torch.empty_like(f) if write_q else None
    if f.numel() == 0:
        return qout, fout
    with torch.cuda.device(dev):
        err = _native.library().cfd_rk3_mega(
            f.data_ptr(), r.data_ptr(), axy.data_ptr(), uz.data_ptr(),
            q.data_ptr() if q is not None else None,
            qout.data_ptr() if write_q else None, fout.data_ptr(), ch1.data_ptr(),
            ch2.data_ptr(), ctypes.byref(c1), ctypes.byref(c2),
            float(a), float(b), float(dt), float(dt) * float(nu), int(write_q),
            f.numel() // nz, nb, h1, win1, h2, win2,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "rk3_mega")
    LAUNCHES += 1
    return qout, fout
