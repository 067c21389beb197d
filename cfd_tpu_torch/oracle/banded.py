"""Serial float64 oracle for compact derivatives (numpy + scipy).

The port of ``cfd_tpu/oracle/banded.py``: the full-line tridiagonal
system of a scheme solved with ``scipy.linalg.solve_banded`` (a dense
solve for periodic lines). It shares no code with the solvers it checks
beyond the scheme tables.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import solve_banded

from ..schemes import CompactScheme, lhs_bands, rhs_matrix

__all__ = ["compact_rhs_np", "solve_line_np", "derivative_np"]


def compact_rhs_np(scheme: CompactScheme, f: np.ndarray, dx: float) -> np.ndarray:
    """RHS of the compact system along the leading axis of ``f``: (n, *batch)."""
    f = np.asarray(f, dtype=np.float64)
    B = rhs_matrix(scheme, f.shape[0])
    return np.tensordot(B, f, axes=(1, 0)) / dx**scheme.derivative_order


def solve_line_np(scheme: CompactScheme, rhs: np.ndarray) -> np.ndarray:
    """Solve the scheme's LHS against ``rhs`` of shape (n, *batch)."""
    rhs = np.asarray(rhs, dtype=np.float64)
    n = rhs.shape[0]
    dl, d, du = lhs_bands(scheme, n)
    flat = rhs.reshape(n, -1)
    if scheme.periodic:
        A = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
        A[0, -1] = scheme.alpha
        A[-1, 0] = scheme.alpha
        return np.linalg.solve(A, flat).reshape(rhs.shape)
    ab = np.zeros((3, n))
    ab[0, 1:] = du[:-1]
    ab[1, :] = d
    ab[2, :-1] = dl[1:]
    return solve_banded((1, 1), ab, flat).reshape(rhs.shape)


def derivative_np(
    scheme: CompactScheme, f: np.ndarray, dx: float, axis: int = 0
) -> np.ndarray:
    """Compact derivative of ``f`` along ``axis`` (float64)."""
    f = np.moveaxis(np.asarray(f, dtype=np.float64), axis, 0)
    x = solve_line_np(scheme, compact_rhs_np(scheme, f, dx))
    return np.moveaxis(x, 0, axis)
