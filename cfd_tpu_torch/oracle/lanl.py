"""LANL phi/psi parameterized-LU distributed tridiagonal oracle (numpy).

The port of ``cfd_tpu/oracle/lanl.py``: the reference's second distributed
algorithm, the CFDNS/Roadrunner parameterized-LU sweeps, in vectorized
numpy with emulated "ranks" (slices of the line) and "allgathers"
(concatenations). It shares no code with the substructuring solve of the
compute path, which is what makes it an oracle for ``method="phipsi"``.

1. ``precompute_beta``: the global LU pivots of the line, once per bands.
2. Forward sweep: block r's forward-substituted values are affine in the
   value coming from block r-1, ``y = phi + y_in * psi``; one gather of
   the blocks' last values closes the recurrence.
3. Backward sweep: the mirror, ``x = theta + x_in * eta``, closed from the
   right (with the right-to-left product starting at 1.0, the python
   port's convention, validated against scipy in the tests).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..schemes import CompactScheme, lhs_bands
from .banded import compact_rhs_np

__all__ = ["precompute_beta", "lanl_solve_np", "lanl_derivative_np"]


def precompute_beta(dl: np.ndarray, d: np.ndarray, du: np.ndarray) -> np.ndarray:
    """Global LU pivots beta[i] = d[i] - dl[i]*du[i-1]/beta[i-1]."""
    n = d.shape[0]
    beta = np.empty(n, dtype=np.float64)
    beta[0] = d[0]
    for i in range(1, n):
        beta[i] = d[i] - dl[i] * du[i - 1] / beta[i - 1]
    return beta


def _block_bounds(n: int, p: int) -> Sequence[tuple]:
    if n % p:
        raise ValueError(f"line length {n} not divisible by {p} blocks")
    m = n // p
    return [(r * m, (r + 1) * m) for r in range(p)]


def lanl_solve_np(
    dl: np.ndarray,
    d: np.ndarray,
    du: np.ndarray,
    rhs: np.ndarray,
    nblocks: int,
) -> np.ndarray:
    """Solve the (acyclic) tridiagonal system with the phi/psi algorithm.

    ``rhs`` has shape (n, *batch); the line is split into ``nblocks`` equal
    blocks, mimicking a distributed line communicator.
    """
    dl, d, du = (np.asarray(a, dtype=np.float64) for a in (dl, d, du))
    rhs = np.asarray(rhs, dtype=np.float64)
    n = d.shape[0]
    bounds = _block_bounds(n, nblocks)
    beta = precompute_beta(dl, d, du)
    bshape = rhs.shape[1:]

    # ---- forward sweep: y = phi + psi * y_in per block -------------------
    phi = np.empty_like(rhs)
    psi = np.zeros((n,), dtype=np.float64)  # psi is RHS-independent
    for s, e in bounds:
        phi[s] = rhs[s]
        psi[s] = -(dl[s] / beta[s - 1]) if s > 0 else 0.0
        for i in range(s + 1, e):
            k = dl[i] / beta[i - 1]
            phi[i] = rhs[i] - k * phi[i - 1]
            psi[i] = -k * psi[i - 1]

    # "allgather" of block faces: (phi_last, psi_last) per block
    phi_last = np.stack([phi[e - 1] for _, e in bounds])  # (p, *batch)
    psi_last = np.array([psi[e - 1] for _, e in bounds])  # (p,)

    # close the recurrence: Y_r = phi_last_r + psi_last_r * Y_{r-1}
    Y = np.empty((nblocks,) + bshape, dtype=np.float64)
    Y[0] = phi_last[0]
    for r in range(1, nblocks):
        Y[r] = phi_last[r] + psi_last[r] * Y[r - 1]

    y = np.empty_like(rhs)
    for r, (s, e) in enumerate(bounds):
        y_in = Y[r - 1] if r > 0 else 0.0
        psi_blk = psi[s:e].reshape((e - s,) + (1,) * len(bshape))
        y[s:e] = phi[s:e] + psi_blk * y_in

    # ---- backward sweep: x = theta + eta * x_in per block ----------------
    theta = np.empty_like(rhs)
    eta = np.zeros((n,), dtype=np.float64)
    for s, e in bounds:
        i = e - 1
        theta[i] = y[i] / beta[i]
        eta[i] = -(du[i] / beta[i]) if i < n - 1 else 0.0
        for i in range(e - 2, s - 1, -1):
            theta[i] = (y[i] - du[i] * theta[i + 1]) / beta[i]
            eta[i] = -(du[i] / beta[i]) * eta[i + 1]

    theta_first = np.stack([theta[s] for s, _ in bounds])
    eta_first = np.array([eta[s] for s, _ in bounds])

    X = np.empty((nblocks,) + bshape, dtype=np.float64)
    X[nblocks - 1] = theta_first[nblocks - 1]
    for r in range(nblocks - 2, -1, -1):
        X[r] = theta_first[r] + eta_first[r] * X[r + 1]

    x = np.empty_like(rhs)
    for r, (s, e) in enumerate(bounds):
        x_in = X[r + 1] if r < nblocks - 1 else 0.0
        eta_blk = eta[s:e].reshape((e - s,) + (1,) * len(bshape))
        x[s:e] = theta[s:e] + eta_blk * x_in
    return x


def lanl_derivative_np(
    scheme: CompactScheme,
    f: np.ndarray,
    dx: float,
    nblocks: int = 4,
    axis: int = 0,
) -> np.ndarray:
    """Compact derivative along ``axis`` via the phi/psi oracle (acyclic only)."""
    if scheme.periodic:
        raise ValueError("the LANL oracle implements non-periodic lines only")
    f = np.moveaxis(np.asarray(f, dtype=np.float64), axis, 0)
    n = f.shape[0]
    dl, d, du = lhs_bands(scheme, n)
    rhs = compact_rhs_np(scheme, f, dx)
    x = lanl_solve_np(dl, d, du, rhs, nblocks)
    return np.moveaxis(x, 0, axis)
