"""Phi/psi (parameterized-LU) distributed tridiagonal solve.

The port of ``cfd_tpu/parallel/phipsi.py``: the reference's second
distributed algorithm (the CFDNS/Roadrunner sweeps), exposed as
``DistributedCompactSolver(..., method="phipsi")``, non-periodic schemes
only.

* The global LU pivots and everything that does not depend on the RHS
  (``psi``, ``eta``, each shard's bidiagonal-block inverses, the rows that
  close the face chains) are precomputed in float64 (``phipsi_tables``).
* Each shard's forward substitution is one dense product with the inverse
  of its unit-lower-bidiagonal block; the serial rank-to-rank closure of
  the face chain ``Y_r = phi_last_r + psi_last_r Y_{r-1}`` becomes one
  ``all_gather`` of faces and a dot with the shard's row of the chain
  matrix. The backward sweep mirrors it with ``theta``/``eta``.

``oracle/lanl.py`` is the independent host version it is held against.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..oracle.lanl import precompute_beta
from ..ops.dist import require_full_f32
from ..schemes import CompactScheme, lhs_bands
from .dist_tables import shard_table
from .mesh import Sharded, all_gather

__all__ = ["phipsi_tables", "PhiPsiTables", "phipsi_lines"]


@dataclasses.dataclass(frozen=True)
class PhiPsiTables:
    """Per-shard phi/psi tables, float64 numpy, stacked over the p shards.

    * ``linv``  — (p, nl, nl) inverses of the unit-lower-bidiagonal forward
                  blocks (phi = linv @ rhs)
    * ``uinv``  — (p, nl, nl) inverses of the upper-bidiagonal backward
                  blocks (theta = uinv @ y)
    * ``psi``   — (p, nl) forward homogeneous solutions
    * ``eta``   — (p, nl) backward homogeneous solutions
    * ``yrow``  — (p, p) row r = coefficients of Y_{r-1} over the gathered
                  forward faces (row 0 is zero)
    * ``xrow``  — (p, p) row r = coefficients of X_{r+1} over the gathered
                  backward faces (row p-1 is zero)
    """

    linv: np.ndarray
    uinv: np.ndarray
    psi: np.ndarray
    eta: np.ndarray
    yrow: np.ndarray
    xrow: np.ndarray


@functools.lru_cache(maxsize=None)
def phipsi_tables(scheme: CompactScheme, n: int, p: int) -> PhiPsiTables:
    if scheme.periodic:
        raise ValueError(
            "method='phipsi' implements non-periodic lines only (reference "
            "npts.c parity); use the default substructuring method"
        )
    if n % p:
        raise ValueError(f"global extent {n} not divisible by mesh axis {p}")
    nl = n // p
    widest = max(
        [len(r.rhs_stencil) for r in scheme.left_rows]
        + [2 * scheme.stencil_width + 1]
    )
    if nl < widest:
        raise ValueError(
            f"local extent {nl} shorter than the closure/interior stencil "
            f"({widest} points) of scheme {scheme.name}; use fewer shards"
        )
    dl, d, du = lhs_bands(scheme, n)
    beta = precompute_beta(dl, d, du)
    k = np.zeros(n)
    k[1:] = dl[1:] / beta[:-1]

    linv = np.zeros((p, nl, nl))
    uinv = np.zeros((p, nl, nl))
    psi = np.zeros((p, nl))
    eta = np.zeros((p, nl))
    for r in range(p):
        s = r * nl
        # forward block: unit lower bidiagonal with subdiagonal k[s+1:s+nl]
        L = np.eye(nl)
        for i in range(1, nl):
            L[i, i - 1] = k[s + i]
        linv[r] = np.linalg.inv(L)
        # homogeneous forward solution: psi[0] = -k[s] (0 for shard 0)
        if r > 0:
            psi[r, 0] = -k[s]
            for i in range(1, nl):
                psi[r, i] = -k[s + i] * psi[r, i - 1]
        # backward block: diag beta, superdiagonal du
        U = np.diag(beta[s : s + nl])
        for i in range(nl - 1):
            U[i, i + 1] = du[s + i]
        uinv[r] = np.linalg.inv(U)
        # homogeneous backward solution: eta[nl-1] = -du/beta (0 for last)
        if r < p - 1:
            eta[r, nl - 1] = -du[s + nl - 1] / beta[s + nl - 1]
            for i in range(nl - 2, -1, -1):
                eta[r, i] = -(du[s + i] / beta[s + i]) * eta[r, i + 1]

    # chain closures as dense coefficient rows over the gathered faces:
    #   Y_r = sum_{j<=r} (prod_{t=j+1..r} psi_last_t) phi_last_j
    psi_last = psi[:, -1]
    CY = np.zeros((p, p))
    for r in range(p):
        acc = 1.0
        for j in range(r, -1, -1):
            CY[r, j] = acc
            acc *= psi_last[j]
    eta_first = eta[:, 0]
    CX = np.zeros((p, p))
    for r in range(p - 1, -1, -1):
        acc = 1.0
        for j in range(r, p):
            CX[r, j] = acc
            acc *= eta_first[j]
    yrow = np.zeros((p, p))
    yrow[1:] = CY[:-1]  # shard r consumes Y_{r-1}
    xrow = np.zeros((p, p))
    xrow[:-1] = CX[1:]  # shard r consumes X_{r+1}
    return PhiPsiTables(
        linv=linv, uinv=uinv, psi=psi, eta=eta, yrow=yrow, xrow=xrow
    )



def phipsi_lines(rhs: Sharded, tables: PhiPsiTables, *, axis: int) -> Sharded:
    """Distributed phi/psi solve of shard-local lines ``rhs`` (nl, *batch),
    the line along mesh ``axis``; shard r reads row r of each table."""
    require_full_f32(rhs.dtype)

    def tab(name, coord, like):
        return shard_table(tables, name, coord[axis], like.dtype, like.device)

    flat = rhs.map(lambda r: r.reshape(r.shape[0], -1))
    # forward sweep: phi = L^{-1} rhs, then close the face chain with this
    # shard's coefficient row over the gathered faces
    phi = flat.map(lambda c, r: tab("linv", c, r) @ r, coords=True)
    faces = all_gather(phi.map(lambda t: t[-1:]), axis)  # (p, B)
    y = phi.map(
        lambda c, t, fc: t + tab("psi", c, t)[:, None] * (tab("yrow", c, t) @ fc)[None, :],
        faces, coords=True,
    )
    # backward sweep: theta = U^{-1} y, then close the mirror chain
    theta = y.map(lambda c, t: tab("uinv", c, t) @ t, coords=True)
    faces_b = all_gather(theta.map(lambda t: t[:1]), axis)
    x = theta.map(
        lambda c, t, fc: t + tab("eta", c, t)[:, None] * (tab("xrow", c, t) @ fc)[None, :],
        faces_b, coords=True,
    )
    return x.map(lambda t, r: t.reshape(r.shape), rhs)
