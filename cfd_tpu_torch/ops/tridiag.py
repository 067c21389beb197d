"""Tridiagonal factor tables (numpy, float64) and their plain solves.

The port of ``cfd_tpu/ops/tridiag.py``. A compact scheme's LHS is one set
of bands shared by every line, so everything that does not depend on the
right-hand side is computed once here in float64; the kernels read these
tables as float32 and run only the sweeps.

* ``thomas_factor`` — LU (Thomas) multipliers; ``thomas_solve`` applies
  them with two sweeps over the line.
* ``pcr_factor`` / ``pcr_solve`` — parallel cyclic reduction: per-level
  RHS-update coefficients, applied as ceil(log2 n) shifted multiply-adds
  over the whole batch (the distributed layer's ``"pcr"`` local solve).
* ``cyclic_factor`` / ``cyclic_solve`` — a periodic (cyclic) system as an
  acyclic core plus a Sherman–Morrison rank-1 correction with
  precomputed ``q``.

Solves take a tensor with the line along ``axis`` (default 0) and run in
its dtype on its device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "ThomasFactors",
    "PCRFactors",
    "CyclicFactors",
    "thomas_factor",
    "thomas_solve",
    "pcr_factor",
    "pcr_solve",
    "cyclic_factor",
    "cyclic_solve",
    "solve",
    "factor",
]


class ThomasFactors(NamedTuple):
    """Precomputed LU multipliers; all shape (n,).

    ``w[i]``    — forward multiplier dl[i]/dhat[i-1] (w[0] = 0)
    ``invd[i]`` — 1/dhat[i]
    ``du[i]``   — original superdiagonal (du[n-1] = 0)
    """

    w: np.ndarray
    invd: np.ndarray
    du: np.ndarray


class PCRFactors(NamedTuple):
    """Per-level RHS-update coefficients; k1/k2 shape (L, n), invb (n,).

    Level l eliminates stride ``2**l`` couplings:
        d <- d - k1[l]*shift_down(d, 2**l) - k2[l]*shift_up(d, 2**l)
    and finally x = invb * d.
    """

    k1: np.ndarray
    k2: np.ndarray
    invb: np.ndarray


class CyclicFactors(NamedTuple):
    """Sherman–Morrison data for a cyclic system A = A' + u v^T.

    ``core``      — Thomas factors of the modified (acyclic) A'
    ``q``         — A'^{-1} u, shape (n,)
    ``v0, vn``    — components of v (v = v0*e0 + vn*e_{n-1})
    ``inv_denom`` — 1/(1 + v·q)
    """

    core: ThomasFactors
    q: np.ndarray
    v0: float
    vn: float
    inv_denom: float


def _thomas_solve_np(dl, d, du, rhs):
    """Plain float64 Thomas solve (setup time only)."""
    dl, d, du, rhs = (np.asarray(a, dtype=np.float64) for a in (dl, d, du, rhs))
    n = d.shape[0]
    dhat = d.copy()
    y = rhs.copy()
    for i in range(1, n):
        w = dl[i] / dhat[i - 1]
        dhat[i] = d[i] - w * du[i - 1]
        y[i] = y[i] - w * y[i - 1]
    x = np.empty_like(y)
    x[n - 1] = y[n - 1] / dhat[n - 1]
    for i in range(n - 2, -1, -1):
        x[i] = (y[i] - du[i] * x[i + 1]) / dhat[i]
    return x


def thomas_factor(dl, d, du) -> ThomasFactors:
    """LU multipliers for bands (dl, d, du), each shape (n,)."""
    dl, d, du = (np.asarray(a, dtype=np.float64) for a in (dl, d, du))
    n = d.shape[0]
    w = np.zeros(n)
    dhat = np.empty(n)
    dhat[0] = d[0]
    for i in range(1, n):
        w[i] = dl[i] / dhat[i - 1]
        dhat[i] = d[i] - w[i] * du[i - 1]
    du = du.copy()
    du[-1] = 0.0
    return ThomasFactors(w=w, invd=1.0 / dhat, du=du)


def _line_view(x: np.ndarray, t: torch.Tensor, axis: int) -> torch.Tensor:
    """A float64 table row ``x`` (n,) as a tensor shaped to broadcast along
    ``axis`` of ``t``, in its dtype and on its device."""
    shape = [1] * t.ndim
    shape[axis] = x.shape[0]
    return torch.as_tensor(x, dtype=t.dtype, device=t.device).reshape(shape)


def thomas_solve(factors: ThomasFactors, rhs: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Solve for every line of ``rhs`` along ``axis`` (two sweeps)."""
    x = rhs.movedim(axis, 0)
    w, invd, du = (torch.as_tensor(v, dtype=rhs.dtype, device=rhs.device)
                   for v in factors)
    y = [x[0]]
    for i in range(1, x.shape[0]):
        y.append(x[i] - w[i] * y[-1])
    out = [y[-1] * invd[-1]]
    for i in range(x.shape[0] - 2, -1, -1):
        out.append((y[i] - du[i] * out[-1]) * invd[i])
    return torch.stack(out[::-1]).movedim(0, axis)


def pcr_factor(dl, d, du) -> PCRFactors:
    """Precompute PCR elimination tables for bands (dl, d, du)."""
    a, b, c = (np.array(v, dtype=np.float64) for v in (dl, d, du))
    n = b.shape[0]
    a[0] = 0.0
    c[-1] = 0.0
    levels = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    k1s = np.zeros((levels, n))
    k2s = np.zeros((levels, n))
    idx = np.arange(n)
    for level in range(levels):
        s = 1 << level
        im = idx - s
        ip = idx + s
        b_im = np.where(im >= 0, b[np.clip(im, 0, n - 1)], 1.0)
        b_ip = np.where(ip < n, b[np.clip(ip, 0, n - 1)], 1.0)
        a_im = np.where(im >= 0, a[np.clip(im, 0, n - 1)], 0.0)
        c_im = np.where(im >= 0, c[np.clip(im, 0, n - 1)], 0.0)
        a_ip = np.where(ip < n, a[np.clip(ip, 0, n - 1)], 0.0)
        c_ip = np.where(ip < n, c[np.clip(ip, 0, n - 1)], 0.0)
        k1 = a / b_im
        k2 = c / b_ip
        k1s[level] = k1
        k2s[level] = k2
        b = b - k1 * c_im - k2 * a_ip
        a = -k1 * a_im
        c = -k2 * c_ip
    return PCRFactors(k1=k1s, k2=k2s, invb=1.0 / b)


def pcr_solve(factors: PCRFactors, rhs: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Apply precomputed PCR tables to ``rhs`` along ``axis``: every level
    is a shifted multiply-add over the whole batch, zero-filled at the
    line's ends."""
    axis = axis % rhs.ndim
    n = rhs.shape[axis]
    d = rhs
    for level in range(factors.k1.shape[0]):
        s = 1 << level
        zeros = d.new_zeros(d.shape[:axis] + (min(s, n),) + d.shape[axis + 1 :])
        down = torch.cat([zeros, d.narrow(axis, 0, n - s)], axis) if s < n else zeros
        up = torch.cat([d.narrow(axis, s, n - s), zeros], axis) if s < n else zeros
        d = (d - _line_view(factors.k1[level], d, axis) * down
             - _line_view(factors.k2[level], d, axis) * up)
    return _line_view(factors.invb, d, axis) * d


def cyclic_factor(dl, d, du, corner_top: float, corner_bot: float,
                  method: str = "thomas") -> CyclicFactors:
    """Factor a cyclic tridiagonal system over a Thomas (or PCR) core.

    ``corner_top`` couples row 0 to x[n-1]; ``corner_bot`` couples row n-1
    to x[0] (both equal alpha for periodic compact schemes). The same split
    as ``cfd_tpu.ops.tridiag.cyclic_factor(..., method)``.
    """
    dl, d, du = (np.asarray(a, dtype=np.float64) for a in (dl, d, du))
    n = d.shape[0]
    gamma = -d[0]
    d_mod = d.copy()
    d_mod[0] = d[0] - gamma
    d_mod[-1] = d[-1] - corner_top * corner_bot / gamma
    core = factor(dl, d_mod, du, method)
    u = np.zeros(n)
    u[0] = gamma
    u[-1] = corner_bot
    q = _thomas_solve_np(dl, d_mod, du, u)
    v0 = 1.0
    vn = corner_top / gamma
    denom = 1.0 + v0 * q[0] + vn * q[-1]
    return CyclicFactors(core=core, q=q, v0=v0, vn=vn, inv_denom=1.0 / denom)


def cyclic_solve(factors: CyclicFactors, rhs: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Solve the cyclic system against ``rhs`` along ``axis``."""
    axis = axis % rhs.ndim
    y = solve(factors.core, rhs, axis)
    n = y.shape[axis]
    vy = factors.v0 * y.narrow(axis, 0, 1) + factors.vn * y.narrow(axis, n - 1, 1)
    return y - _line_view(factors.q, y, axis) * (factors.inv_denom * vy)


def solve(factors, rhs: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Dispatch on the factor type; solves along ``axis``."""
    if isinstance(factors, ThomasFactors):
        return thomas_solve(factors, rhs, axis)
    if isinstance(factors, PCRFactors):
        return pcr_solve(factors, rhs, axis)
    if isinstance(factors, CyclicFactors):
        return cyclic_solve(factors, rhs, axis)
    raise TypeError(f"unknown factor type {type(factors)}")


def factor(dl, d, du, method: str = "pcr"):
    """Factor acyclic bands with the chosen method ('pcr' | 'thomas')."""
    return {"pcr": pcr_factor, "thomas": thomas_factor}[method](dl, d, du)
