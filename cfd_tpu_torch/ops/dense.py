"""The plain PyTorch version of every compact derivative: a dense operator.

The compact derivative is linear in f, f' = T^{-1} B f / dx**order, so
``M = T^{-1} B`` (built once per (scheme, n) in float64) applied as one
matrix product along the axis is the same function as the kernels, with no
recurrence in it. It serves ``method="matmul"``, every tensor on the CPU,
and the float64 reference that the kernels are held against on the card
(with ``torch.backends.cuda.matmul.allow_tf32 = False`` for float32).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..schemes import CompactScheme, lhs_bands, rhs_matrix

__all__ = ["dense_operator", "dense_derivative"]


@functools.lru_cache(maxsize=None)
def dense_operator(scheme: CompactScheme, n: int) -> np.ndarray:
    """Dense derivative operator M = T^{-1} B (float64 numpy, (n, n))."""
    B = rhs_matrix(scheme, n)
    dl, d, du = lhs_bands(scheme, n)
    T = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    if scheme.periodic:
        T[0, -1] = scheme.alpha
        T[-1, 0] = scheme.alpha
    return np.linalg.solve(T, B)


@functools.lru_cache(maxsize=64)
def _scaled_operator(scheme, n, dx, dtype, device):
    M = dense_operator(scheme, n) / float(dx) ** scheme.derivative_order
    return torch.as_tensor(M, dtype=dtype, device=device)


def dense_derivative(f: torch.Tensor, dx, scheme: CompactScheme, axis: int) -> torch.Tensor:
    """Compact derivative of ``f`` along ``axis`` by the dense operator.

    Returns a contiguous tensor of ``f``'s shape, dtype and device.
    """
    axis = axis % f.ndim
    n = f.shape[axis]
    M = _scaled_operator(scheme, n, float(dx), f.dtype, f.device)
    if axis == f.ndim - 1:
        out = f.reshape(-1, n) @ M.T
    else:
        outer = math.prod(f.shape[:axis])
        out = M @ f.reshape(outer, n, -1)
    return out.reshape(f.shape)
