"""Tridiagonal factor tables (numpy, float64).

The port of the factor-table functions of ``cfd_tpu/ops/tridiag.py``. A compact
scheme's LHS is one set of bands shared by every line, so everything that
does not depend on the right-hand side is computed once here in float64;
the kernels read these tables as float32 and run only the sweeps.

* ``thomas_factor`` — LU (Thomas) multipliers.
* ``cyclic_factor`` — a periodic (cyclic) system as a Thomas core plus a
  Sherman–Morrison rank-1 correction with precomputed ``q``.

The JAX package's PCR tables are not ported: no path of the port solves by
parallel cyclic reduction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["ThomasFactors", "CyclicFactors", "thomas_factor", "cyclic_factor"]


class ThomasFactors(NamedTuple):
    """Precomputed LU multipliers; all shape (n,).

    ``w[i]``    — forward multiplier dl[i]/dhat[i-1] (w[0] = 0)
    ``invd[i]`` — 1/dhat[i]
    ``du[i]``   — original superdiagonal (du[n-1] = 0)
    """

    w: np.ndarray
    invd: np.ndarray
    du: np.ndarray


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


def cyclic_factor(dl, d, du, corner_top: float, corner_bot: float) -> CyclicFactors:
    """Factor a cyclic tridiagonal system over a Thomas core.

    ``corner_top`` couples row 0 to x[n-1]; ``corner_bot`` couples row n-1
    to x[0] (both equal alpha for periodic compact schemes). The same split
    as ``cfd_tpu.ops.tridiag.cyclic_factor(..., method="thomas")``.
    """
    dl, d, du = (np.asarray(a, dtype=np.float64) for a in (dl, d, du))
    n = d.shape[0]
    gamma = -d[0]
    d_mod = d.copy()
    d_mod[0] = d[0] - gamma
    d_mod[-1] = d[-1] - corner_top * corner_bot / gamma
    core = thomas_factor(dl, d_mod, du)
    u = np.zeros(n)
    u[0] = gamma
    u[-1] = corner_bot
    q = _thomas_solve_np(dl, d_mod, du, u)
    v0 = 1.0
    vn = corner_top / gamma
    denom = 1.0 + v0 * q[0] + vn * q[-1]
    return CyclicFactors(core=core, q=q, v0=v0, vn=vn, inv_denom=1.0 / denom)
