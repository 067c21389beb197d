"""The plain PyTorch version of every compact derivative: a dense operator.

The compact derivative is linear in f, f' = T^{-1} B f / dx**order, so
``M = T^{-1} B`` (built once per (scheme, n) in float64) applied as one
matrix product along the axis is the same function as the kernels, with no
recurrence in it. It serves ``method="matmul"``, every tensor on the CPU,
and the float64 reference that the kernels are held against on the card
(with ``torch.backends.cuda.matmul.allow_tf32 = False`` for float32).

In float64 an x-line (the last axis) of more than ``BANDED_PAST`` points
takes the derivative as the banded (PCR, cyclic for a periodic scheme)
solve of the same compact system instead: the same function, without the (n, n) operator, which is
1.2 GB and seconds of host time to build at n = 12278. Other dtypes keep
the dense product there, the plain version timed beside the kernels.

The fused substep's plain versions (``ops/adv_lap.py``, ``ops/megastep.py``)
apply the scheme's two sides on their own as well: ``dense_apply`` takes
``"derivative"`` (T^{-1} B), ``"rhs"`` (B), ``"lhs"`` (T) or
``"lhs_inverse"`` (T^{-1}).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..schemes import CompactScheme, lhs_bands, rhs_matrix
from . import tridiag
from .rhs import compact_rhs

__all__ = ["lhs_matrix", "dense_operator", "dense_apply", "dense_derivative"]


@functools.lru_cache(maxsize=None)
def lhs_matrix(scheme: CompactScheme, n: int) -> np.ndarray:
    """Dense LHS T (float64 numpy, (n, n)), with the cyclic corners."""
    dl, d, du = lhs_bands(scheme, n)
    T = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    if scheme.periodic:
        T[0, -1] = scheme.alpha
        T[-1, 0] = scheme.alpha
    return T


@functools.lru_cache(maxsize=None)
def dense_operator(scheme: CompactScheme, n: int) -> np.ndarray:
    """Dense derivative operator M = T^{-1} B (float64 numpy, (n, n))."""
    return np.linalg.solve(lhs_matrix(scheme, n), rhs_matrix(scheme, n))


_MATRICES = {
    "derivative": dense_operator,
    "rhs": rhs_matrix,
    "lhs": lhs_matrix,
    "lhs_inverse": lambda scheme, n: np.linalg.inv(lhs_matrix(scheme, n)),
}


@functools.lru_cache(maxsize=64)
def _scaled_matrix(kind, scheme, n, div, dtype, device):
    M = _MATRICES[kind](scheme, n) / div
    return torch.as_tensor(M, dtype=dtype, device=device)


def dense_apply(
    kind: str, f: torch.Tensor, scheme: CompactScheme, axis: int, div: float = 1.0
) -> torch.Tensor:
    """One of the scheme's (n, n) matrices (see module doc), divided by
    ``div``, applied along ``axis`` of ``f``.

    Returns a contiguous tensor of ``f``'s shape, dtype and device.
    """
    axis = axis % f.ndim
    n = f.shape[axis]
    M = _scaled_matrix(kind, scheme, n, float(div), f.dtype, f.device)
    if axis == f.ndim - 1:
        out = f.reshape(-1, n) @ M.T
    else:
        outer = math.prod(f.shape[:axis])
        out = M @ f.reshape(outer, n, -1)
    return out.reshape(f.shape)


BANDED_PAST = 1024  # longest float64 x-line taken through the dense operator


@functools.lru_cache(maxsize=None)
def _line_factors(scheme: CompactScheme, n: int):
    # PCR: log2(n) steps over the whole field, where Thomas takes 2 n
    dl, d, du = lhs_bands(scheme, n)
    if scheme.periodic:
        return tridiag.cyclic_factor(dl, d, du, scheme.alpha, scheme.alpha, "pcr")
    return tridiag.pcr_factor(dl, d, du)


def _banded_x(f: torch.Tensor, dx, scheme: CompactScheme) -> torch.Tensor:
    # the compact system's RHS on every x-line, then its banded solve
    n = f.shape[-1]
    rhs = compact_rhs(f.reshape(-1, n).T.contiguous(), dx, scheme)
    return tridiag.solve(_line_factors(scheme, n), rhs, 0).T.reshape(f.shape).contiguous()


def dense_derivative(f: torch.Tensor, dx, scheme: CompactScheme, axis: int) -> torch.Tensor:
    """Compact derivative of ``f`` along ``axis`` by the dense operator, or
    in float64 on an x-line past ``BANDED_PAST`` points by the banded solve
    (see module doc).

    Returns a contiguous tensor of ``f``'s shape, dtype and device.
    """
    if f.dtype == torch.float64 and axis % f.ndim == f.ndim - 1 and f.shape[-1] > BANDED_PAST:
        return _banded_x(f, dx, scheme)
    div = float(dx) ** scheme.derivative_order
    return dense_apply("derivative", f, scheme, axis, div)
