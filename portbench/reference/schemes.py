"""The compact schemes the cells run, written out from their coefficients.

Lele (1992), "Compact finite difference schemes with spectral-like
resolution", J. Comput. Phys. 103:16-42:

- 4th-order Pade first derivative (section 2.1, alpha = 1/4, a = 3/2):
  ``alpha f'[i-1] + f'[i] + alpha f'[i+1] = (a / 2) (f[i+1] - f[i-1]) / h``;
  on a bounded line closed by the 3rd-order row of section 4.1 (alpha = 2)
  ``f'[0] + 2 f'[1] = (-5/2 f[0] + 2 f[1] + 1/2 f[2]) / h``, mirrored at
  the right end with the sign of an odd derivative;
- 4th-order Pade second derivative (section 2.2, alpha = 1/10, a = 6/5):
  ``alpha f''[i-1] + f''[i] + alpha f''[i+1] = a (f[i+1] - 2 f[i] +
  f[i-1]) / h**2``.

Nothing here comes from the program: the operators are built from these
numbers alone, in float64.
"""

from __future__ import annotations

import numpy as np

__all__ = ["D1_ALPHA", "D1_A", "D2_ALPHA", "D2_A", "CLOSURE_LHS", "CLOSURE_RHS",
           "d1_symbol", "d2_symbol", "d1_matrix"]

D1_ALPHA, D1_A = 0.25, 1.5
D2_ALPHA, D2_A = 0.1, 1.2
CLOSURE_LHS = (1.0, 2.0)          # f'[0], f'[1]
CLOSURE_RHS = (-2.5, 2.0, 0.5)    # f[0], f[1], f[2]


def d1_symbol(theta: np.ndarray) -> np.ndarray:
    """Modified wavenumber k'(theta) h of the periodic first derivative:
    ``exp(i k x)`` goes to ``i d1_symbol(k h) / h exp(i k x)``; odd in theta,
    and exactly 0 at theta = 0 and pi."""
    theta = np.asarray(theta, dtype=np.float64)
    out = D1_A * np.sin(theta) / (1.0 + 2.0 * D1_ALPHA * np.cos(theta))
    # sin(pi) is 1.2e-16 in floating point; the operator's value there is 0
    out[np.isclose(np.abs(theta), np.pi, rtol=0.0, atol=1e-12)] = 0.0
    return out


def d2_symbol(theta: np.ndarray) -> np.ndarray:
    """Modified wavenumber k''(theta) h**2 of the periodic second
    derivative: ``exp(i k x)`` goes to ``-d2_symbol(k h) / h**2 exp(i k x)``."""
    theta = np.asarray(theta, dtype=np.float64)
    return 2.0 * D2_A * (1.0 - np.cos(theta)) / (1.0 + 2.0 * D2_ALPHA * np.cos(theta))


def d1_matrix(n: int, h: float, periodic: bool = False) -> np.ndarray:
    """The dense first-derivative operator ``T^{-1} B / h`` on ``n`` points,
    float64: the bounded line with the closure rows, or the periodic one."""
    t = np.eye(n)
    b = np.zeros((n, n))
    for i in range(n):
        for j, w in ((i - 1, D1_ALPHA), (i + 1, D1_ALPHA)):
            if periodic or 0 <= j < n:
                t[i, j % n] += w
        for j, w in ((i - 1, -D1_A / 2), (i + 1, D1_A / 2)):
            if periodic or 0 <= j < n:
                b[i, j % n] += w
    if not periodic:
        for row, sign, step in ((0, 1.0, 1), (n - 1, -1.0, -1)):
            t[row] = 0.0
            b[row] = 0.0
            for k, w in enumerate(CLOSURE_LHS):
                t[row, row + step * k] = w
            for k, w in enumerate(CLOSURE_RHS):
                b[row, row + step * k] = sign * w
    return np.linalg.solve(t, b) / h
