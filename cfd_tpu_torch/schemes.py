"""Compact finite-difference scheme tables (numpy, float64).

The port of ``cfd_tpu/schemes.py``. A compact (Padé) scheme couples the
unknown derivatives through a tridiagonal left-hand side,

    alpha * f'[i-1] + f'[i] + alpha * f'[i+1] = RHS(f)[i] / dx**order

with the interior stencil

    RHS(f)[i] = c0 * f[i] + sum_k  w_k * (f[i+k] + sign * f[i-k])

(sign = -1 and c0 = 0 for first derivatives) and, for non-periodic lines,
one-sided closure rows at each edge. Every solver, kernel table and oracle
of the port is built from these tables, so the tables are the parameters
carried across from the JAX package: ``scheme_from_dict`` turns
``dataclasses.asdict`` of a ``cfd_tpu`` scheme into the port's scheme.

This module imports numpy only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

__all__ = [
    "BoundaryRow",
    "CompactScheme",
    "SCHEME4",
    "SCHEME6",
    "SCHEME4_PERIODIC",
    "SCHEME6_PERIODIC",
    "SCHEME4_D2",
    "SCHEME6_D2",
    "SCHEME4_D2_PERIODIC",
    "SCHEME6_D2_PERIODIC",
    "get_scheme",
    "get_filter",
    "lhs_bands",
    "rhs_matrix",
    "scheme_from_dict",
    "transfer_function",
]


@dataclasses.dataclass(frozen=True)
class BoundaryRow:
    """One closure row of the scheme, expressed from the *left* edge.

    ``lhs`` is the (sub, diag, super) entry of the tridiagonal LHS for this
    row; ``rhs_stencil`` are dense weights over the first
    ``len(rhs_stencil)`` grid values, so the equation for row j is

        lhs[0]*f'[j-1] + lhs[1]*f'[j] + lhs[2]*f'[j+1]
            = sum_m rhs_stencil[m] * f[m] / dx
    """

    lhs: Tuple[float, float, float]
    rhs_stencil: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class CompactScheme:
    """A compact derivative scheme (interior + closures).

    ``derivative_order`` is 1 (antisymmetric RHS, 1/dx scaling), 2
    (symmetric RHS with a -2 f[i] centre term, 1/dx**2 scaling) or 0 (a
    filter: symmetric RHS with an explicit ``rhs_center_weight``).
    """

    name: str
    order: int
    periodic: bool
    alpha: float
    rhs_offsets: Tuple[int, ...]
    rhs_weights: Tuple[float, ...]
    left_rows: Tuple[BoundaryRow, ...] = ()
    derivative_order: int = 1
    rhs_center_weight: float = None

    @property
    def rhs_sign(self) -> float:
        """Sign of the f[i-k] term: -1 (odd derivative) or +1 (even)."""
        return -1.0 if self.derivative_order % 2 else 1.0

    @property
    def rhs_center(self) -> float:
        """Weight of the f[i] centre term (0 for first derivatives)."""
        if self.rhs_center_weight is not None:
            return self.rhs_center_weight
        if self.derivative_order % 2:
            return 0.0
        if self.derivative_order == 0:
            raise ValueError(
                f"scheme {self.name}: derivative_order=0 (filter) requires "
                "an explicit rhs_center_weight"
            )
        return -2.0 * sum(self.rhs_weights)

    @property
    def stencil_width(self) -> int:
        """Halo width required by the interior RHS stencil."""
        return max(self.rhs_offsets)

    @property
    def n_closure(self) -> int:
        return len(self.left_rows)

    @property
    def right_rows(self) -> Tuple[BoundaryRow, ...]:
        """Closure rows at the right edge, mirrored from the left ones.

        Row j from the right: lhs reversed, RHS stencil negated for odd
        derivative orders (x -> -x flips the sign of f' but not of f''),
        indexing f from the right edge inward.
        """
        s = self.rhs_sign
        return tuple(
            BoundaryRow(
                lhs=row.lhs[::-1],
                rhs_stencil=tuple(s * w for w in row.rhs_stencil),
            )
            for row in self.left_rows
        )

    def min_points(self) -> int:
        if self.periodic:
            return 2 * self.stencil_width + 1
        widest = max(
            [len(r.rhs_stencil) for r in self.left_rows] + [2 * self.stencil_width + 1]
        )
        return max(widest, 2 * self.n_closure + 1)


# 4th-order Padé interior:  (1/4, 1, 1/4) f' = (3/4)(f[i+1]-f[i-1])/dx
# 3rd-order closure:        f'[0] + 2 f'[1] = (-5 f0 + 4 f1 + f2) / (2 dx)
SCHEME4 = CompactScheme(
    name="pade4",
    order=4,
    periodic=False,
    alpha=0.25,
    rhs_offsets=(1,),
    rhs_weights=(0.75,),
    left_rows=(BoundaryRow(lhs=(0.0, 1.0, 2.0), rhs_stencil=(-2.5, 2.0, 0.5)),),
)

SCHEME4_PERIODIC = dataclasses.replace(
    SCHEME4, name="pade4_periodic", periodic=True, left_rows=()
)

# 6th-order tridiagonal interior (Lele 1992 eq. 2.1.7), closed with a
# 5th-order one-sided wall row and the 4th-order Padé row next to the wall.
SCHEME6 = CompactScheme(
    name="lele6",
    order=6,
    periodic=False,
    alpha=1.0 / 3.0,
    rhs_offsets=(1, 2),
    rhs_weights=(7.0 / 9.0, 1.0 / 36.0),
    left_rows=(
        BoundaryRow(
            lhs=(0.0, 1.0, 5.0),
            rhs_stencil=(
                -197.0 / 60.0,
                -5.0 / 12.0,
                5.0,
                -5.0 / 3.0,
                5.0 / 12.0,
                -1.0 / 20.0,
            ),
        ),
        BoundaryRow(lhs=(0.25, 1.0, 0.25), rhs_stencil=(-0.75, 0.0, 0.75)),
    ),
)

SCHEME6_PERIODIC = dataclasses.replace(
    SCHEME6, name="lele6_periodic", periodic=True, left_rows=()
)

# Second-derivative schemes (Lele 1992 §2.2/§4.3); interior RHS
# sum_k w_k (f[i+k] - 2 f[i] + f[i-k]) / dx^2.
SCHEME4_D2 = CompactScheme(
    name="pade4_d2",
    order=4,
    periodic=False,
    alpha=0.1,
    rhs_offsets=(1,),
    rhs_weights=(1.2,),
    left_rows=(BoundaryRow(lhs=(0.0, 1.0, 11.0), rhs_stencil=(13.0, -27.0, 15.0, -1.0)),),
    derivative_order=2,
)

SCHEME4_D2_PERIODIC = dataclasses.replace(
    SCHEME4_D2, name="pade4_d2_periodic", periodic=True, left_rows=()
)

SCHEME6_D2 = CompactScheme(
    name="lele6_d2",
    order=6,
    periodic=False,
    alpha=2.0 / 11.0,
    rhs_offsets=(1, 2),
    rhs_weights=(12.0 / 11.0, 3.0 / 44.0),
    left_rows=(
        BoundaryRow(
            lhs=(0.0, 1.0, 137.0 / 13.0),
            rhs_stencil=(
                1955.0 / 156.0,
                -4057.0 / 156.0,
                1117.0 / 78.0,
                -55.0 / 78.0,
                -29.0 / 156.0,
                7.0 / 156.0,
            ),
        ),
        BoundaryRow(lhs=(0.1, 1.0, 0.1), rhs_stencil=(1.2, -2.4, 1.2)),
    ),
    derivative_order=2,
)

SCHEME6_D2_PERIODIC = dataclasses.replace(
    SCHEME6_D2, name="lele6_d2_periodic", periodic=True, left_rows=()
)

_SCHEMES = {
    (4, False, 1): SCHEME4,
    (4, True, 1): SCHEME4_PERIODIC,
    (6, False, 1): SCHEME6,
    (6, True, 1): SCHEME6_PERIODIC,
    (4, False, 2): SCHEME4_D2,
    (4, True, 2): SCHEME4_D2_PERIODIC,
    (6, False, 2): SCHEME6_D2,
    (6, True, 2): SCHEME6_D2_PERIODIC,
}


@functools.lru_cache(maxsize=None)
def get_filter(
    order: int = 6, alpha: float = 0.45, periodic: bool = False
) -> CompactScheme:
    """Compact (Padé-type) low-pass filter of the given order (Lele 1992 §C).

        alpha fh[i-1] + fh[i] + alpha fh[i+1]
            = c0 f[i] + sum_k w_k (f[i+k] + f[i-k])

    with G(0) = 1, G(pi) = 0 and G(k) = 1 - O(k^order). Non-periodic lines
    leave the outermost ``order/2`` points unfiltered (identity rows).
    """
    if not -0.5 < alpha < 0.5:
        raise ValueError(f"filter alpha must be in (-0.5, 0.5), got {alpha}")
    if order == 4:
        weights = ((1.0 + 2.0 * alpha) / 4.0, -(1.0 - 2.0 * alpha) / 16.0)
        center = (5.0 + 6.0 * alpha) / 8.0
        offsets = (1, 2)
    elif order == 6:
        weights = (
            15.0 / 64.0 + 17.0 * alpha / 32.0,
            -3.0 * (1.0 - 2.0 * alpha) / 32.0,
            (1.0 - 2.0 * alpha) / 64.0,
        )
        center = (11.0 + 10.0 * alpha) / 16.0
        offsets = (1, 2, 3)
    else:
        raise ValueError(f"no compact filter of order {order}; available: 4, 6")
    width = max(offsets)
    rows = tuple(
        BoundaryRow(lhs=(0.0, 1.0, 0.0), rhs_stencil=(0.0,) * j + (1.0,))
        for j in range(width)
    )
    return CompactScheme(
        name=f"filter{order}_a{alpha:g}" + ("_periodic" if periodic else ""),
        order=order,
        periodic=periodic,
        alpha=alpha,
        rhs_offsets=offsets,
        rhs_weights=weights,
        left_rows=() if periodic else rows,
        derivative_order=0,
        rhs_center_weight=center,
    )


def get_scheme(
    order: int = 4, periodic: bool = False, derivative: int = 1
) -> CompactScheme:
    """Scheme of accuracy ``order`` for the ``derivative``-th derivative."""
    try:
        return _SCHEMES[(order, periodic, derivative)]
    except KeyError:
        raise ValueError(
            f"no compact scheme of order {order} (periodic={periodic}, "
            f"derivative={derivative}); available: {sorted(_SCHEMES)}"
        ) from None


def scheme_from_dict(d: dict) -> CompactScheme:
    """The port's scheme from ``dataclasses.asdict`` of a ``cfd_tpu`` scheme.

    The dictionary holds plain numbers only, so the JAX package's scheme
    tables cross into the port without importing it.
    """
    d = dict(d)
    d["rhs_offsets"] = tuple(int(k) for k in d["rhs_offsets"])
    d["rhs_weights"] = tuple(float(w) for w in d["rhs_weights"])
    d["left_rows"] = tuple(
        BoundaryRow(
            lhs=tuple(float(v) for v in row["lhs"]),
            rhs_stencil=tuple(float(v) for v in row["rhs_stencil"]),
        )
        for row in d.get("left_rows", ())
    )
    return CompactScheme(**d)


def lhs_bands(
    scheme: CompactScheme, n: int, *, first_block: bool = True, last_block: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return the float64 (dl, d, du) bands of the scheme's LHS for ``n`` rows.

    Non-periodic schemes get their closure rows at the top when
    ``first_block`` and at the bottom when ``last_block``: a block of a
    distributed line that holds neither physical end takes plain interior
    rows (the substructuring method carries its coupling to the
    neighbouring blocks). dl[i] multiplies x[i-1] (dl[0] = 0), du[i]
    multiplies x[i+1] (du[n-1] = 0). The cyclic corners of a periodic
    scheme are not in the bands; the cyclic factor carries them.
    """
    if n < scheme.min_points():
        raise ValueError(f"n={n} too small for scheme {scheme.name}")
    dl = np.full(n, scheme.alpha)
    d = np.ones(n)
    du = np.full(n, scheme.alpha)
    dl[0] = 0.0
    du[-1] = 0.0
    if not scheme.periodic:
        rows = [(j, row) for j, row in enumerate(scheme.left_rows) if first_block]
        rows += [(n - 1 - j, row) for j, row in enumerate(scheme.right_rows) if last_block]
        for i, row in rows:
            a, b, c = row.lhs
            if i > 0:
                dl[i] = a
            d[i] = b
            if i < n - 1:
                du[i] = c
    return dl, d, du


def rhs_matrix(scheme: CompactScheme, n: int) -> np.ndarray:
    """Dense float64 (n, n) matrix B with RHS = B @ f / dx**order."""
    if n < scheme.min_points():
        raise ValueError(f"n={n} too small for scheme {scheme.name}")
    B = np.zeros((n, n))
    s = scheme.rhs_sign
    c0 = scheme.rhs_center
    for k, w in zip(scheme.rhs_offsets, scheme.rhs_weights):
        for i in range(n):
            ip = (i + k) % n if scheme.periodic else i + k
            im = (i - k) % n if scheme.periodic else i - k
            if scheme.periodic or (0 <= ip < n and 0 <= im < n):
                B[i, ip] += w
                B[i, im] += s * w
    if c0:
        B[np.arange(n), np.arange(n)] += c0
    if not scheme.periodic:
        if scheme.n_closure < scheme.stencil_width:
            raise ValueError(
                f"scheme {scheme.name}: row {scheme.n_closure} needs offsets "
                "beyond the boundary but has no closure row"
            )
        for j, row in enumerate(scheme.left_rows):
            B[j, :] = 0.0
            B[j, : len(row.rhs_stencil)] = row.rhs_stencil
        for j, row in enumerate(scheme.right_rows):
            i = n - 1 - j
            B[i, :] = 0.0
            m = len(row.rhs_stencil)
            B[i, n - m :] = row.rhs_stencil[::-1]
    return B


def transfer_function(scheme: CompactScheme, k) -> np.ndarray:
    """Periodic-interior spectral response of the scheme at the scaled
    wavenumber ``k`` (k_phys * dx, in [0, pi]), after Lele 1992:

    * derivative_order 1: the modified wavenumber k'(k); the scheme
      multiplies exp(i k x / dx) by i k' / dx (exact: k' = k);
    * derivative_order 2: the modified squared wavenumber k''(k); the
      scheme multiplies exp(i k x / dx) by -k'' / dx**2 (exact: k'' = k**2);
    * derivative_order 0 (filters): the gain G(k).
    """
    k = np.asarray(k, np.float64)
    lhs = 1.0 + 2.0 * scheme.alpha * np.cos(k)
    w = np.asarray(scheme.rhs_weights)
    j = np.asarray(scheme.rhs_offsets)
    if scheme.derivative_order == 1:
        return 2.0 * (w[:, None] * np.sin(np.outer(j, k))).sum(0) / lhs
    num = scheme.rhs_center + 2.0 * (w[:, None] * np.cos(np.outer(j, k))).sum(0)
    if scheme.derivative_order == 2:
        return -num / lhs
    return num / lhs
