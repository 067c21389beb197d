"""Spectral Poisson solve and Helmholtz projection, consistent with the
compact schemes.

The port of ``cfd_tpu/ops/poisson.py``. Periodic compact operators are
circulant, so the DFT diagonalizes them exactly: a d1 scheme multiplies
``exp(i k x)`` by ``i k'(k dx) / dx`` and a d2 scheme by
``-k''(k dx) / dx**2``, with k' and k'' the scheme's transfer function
(``schemes.transfer_function``). So

- ``solve_poisson`` returns p with ``laplacian(p) == rhs`` for the compact
  Laplacian itself (a d2 scheme: the sum of second derivatives; a d1
  scheme: div(grad(.))), to rounding, not to truncation;
- ``project`` removes exactly the part of u that the compact
  ``divergence`` sees, so ``divergence(project(u)) == 0`` to rounding.

The transforms are ``torch.fft.rfftn``/``irfftn`` (the JAX package leaves
its FFTs to XLA, outside any Pallas kernel). The eigenvalue tables are
built in float64 numpy and cached per scheme, shape, spacing and device.
The TPU's matmul-DFT stages are not ported.

``project`` has two forms, equal in exact arithmetic:

* ``"spectral"``: ``u_hat - k' (k' . u_hat) / |k'|^2`` per mode, six FFTs;
* ``"compact"``: ``u - grad(solve_poisson(div u))``, two FFTs, with the
  divergence fused (K6 + K2's solve) and the gradient subtracted by the
  kernels' epilogues: ``pair_subtract`` for x and y (K1 + K2 with ``acc``)
  and K2 with ``acc=uz`` and spacing ``-dz`` for z.

``"auto"`` takes ``"compact"`` for CUDA float32 (nz, ny, nx) fields, where
the JAX package takes it on the TPU, and ``"spectral"`` otherwise.

Periodic schemes only: closures break the circulant structure.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..schemes import CompactScheme, transfer_function
from . import derivatives, pair, strided

__all__ = [
    "spectral_multipliers",
    "laplacian_eigenvalues",
    "solve_poisson",
    "project",
]

_AXES = (-3, -2, -1)


def _check_periodic(scheme: CompactScheme, who: str) -> None:
    if not scheme.periodic:
        raise ValueError(
            f"{who} requires a periodic scheme (non-periodic closures are not "
            f"circulant, so the DFT does not diagonalize them); got {scheme.name!r}"
        )


@functools.lru_cache(maxsize=64)
def _kprime_1d(scheme: CompactScheme, n: int, rfft: bool) -> np.ndarray:
    """Signed scaled transfer values over one axis's (r)fft frequencies:
    k'(k) (odd) for d1 schemes, k''(k) >= 0 for d2 schemes."""
    j = np.fft.rfftfreq(n) if rfft else np.fft.fftfreq(n)
    k = 2.0 * np.pi * j  # scaled wavenumber in (-pi, pi]
    t = transfer_function(scheme, np.abs(k))
    if scheme.derivative_order == 1:
        t = t * np.sign(k)
    # sin(j pi) ~ 1e-16 at the Nyquist mode of central d1 schemes: k'(pi) = 0
    # is a true null mode (odd-even decoupling), and the inverses must see an
    # exact zero rather than divide by (1e-16)**2
    t[np.abs(t) < 1e-12 * np.abs(t).max()] = 0.0
    return t


def spectral_multipliers(scheme: CompactScheme, shape, spacing):
    """Per-axis float64 multiplier tables ``(mz, my, mx)``, broadcastable
    over an rfftn of the trailing three axes of a ``shape``-d field: the
    derivative along axis a is ``ifft(i m_a fft(f))`` for a d1 scheme and
    ``ifft(-m_a fft(f))`` for a d2 scheme."""
    _check_periodic(scheme, "spectral_multipliers")
    p = scheme.derivative_order
    if p not in (1, 2):
        raise ValueError(
            f"spectral_multipliers needs a derivative scheme, got "
            f"derivative_order={p} ({scheme.name!r})"
        )
    nz, ny, nx = shape[-3:]
    dz, dy, dx = derivatives.spacings3(spacing)
    mz = _kprime_1d(scheme, nz, False) / float(dz) ** p
    my = _kprime_1d(scheme, ny, False) / float(dy) ** p
    mx = _kprime_1d(scheme, nx, True) / float(dx) ** p
    return mz.reshape(-1, 1, 1), my.reshape(1, -1, 1), mx.reshape(1, 1, -1)


def laplacian_eigenvalues(scheme: CompactScheme, shape, spacing) -> np.ndarray:
    """DFT eigenvalues (all <= 0) of the compact Laplacian on ``shape``: of
    d2x + d2y + d2z for a d2 scheme, of div(grad(.)) for a d1 scheme."""
    mz, my, mx = spectral_multipliers(scheme, shape, spacing)
    if scheme.derivative_order == 1:
        return -(mz**2 + my**2 + mx**2)
    return -(mz + my + mx)


def _inverse(values: np.ndarray) -> np.ndarray:
    inv = np.zeros_like(values)
    nonzero = values != 0.0
    inv[nonzero] = 1.0 / values[nonzero]
    return inv


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


@functools.lru_cache(maxsize=32)
def _poisson_table(scheme, shape3, spacing, dtype, device):
    lam = laplacian_eigenvalues(scheme, shape3, spacing)
    return torch.as_tensor(_inverse(lam), dtype=dtype, device=device)


@functools.lru_cache(maxsize=32)
def _projection_tables(scheme, shape3, spacing, dtype, device):
    mz, my, mx = spectral_multipliers(scheme, shape3, spacing)
    inv = _inverse(mz**2 + my**2 + mx**2)
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return put(mz), put(my), put(mx), put(inv)


def _spacing_key(spacing):
    return tuple(float(s) for s in derivatives.spacings3(spacing))


def solve_poisson(rhs: torch.Tensor, spacing, scheme: CompactScheme, *, mean: float = 0.0):
    """p with ``compact_laplacian(p) == rhs`` on a periodic box.

    A d2 ``scheme`` inverts ``laplacian``'s operator, a d1 scheme the
    div(grad(.)) form. ``rhs`` is ``[..., nz, ny, nx]``; ``spacing`` a
    scalar or (dz, dy, dx). Solvability needs mean(rhs) == 0: the solver
    projects the mean out, and the solution's own mean is ``mean``. For a
    d1 scheme every mode that is 0 or Nyquist along all three axes is a
    null mode too; the solver returns the minimum-norm solution.
    """
    _check_periodic(scheme, "solve_poisson")
    if rhs.ndim < 3:
        raise ValueError(f"solve_poisson needs [..., nz, ny, nx], got {tuple(rhs.shape)}")
    shape3 = tuple(rhs.shape[-3:])
    inv = _poisson_table(scheme, shape3, _spacing_key(spacing), _real_dtype(rhs.dtype),
                         rhs.device)
    p_hat = torch.fft.rfftn(rhs, dim=_AXES) * inv
    if mean != 0.0:
        p_hat[..., 0, 0, 0] = mean * math.prod(shape3)
    return torch.fft.irfftn(p_hat, s=shape3, dim=_AXES)


def _project_spectral(ux, uy, uz, scheme, spacing):
    mz, my, mx, inv = _projection_tables(scheme, tuple(ux.shape[-3:]), _spacing_key(spacing),
                                         _real_dtype(ux.dtype), ux.device)
    uh = [torch.fft.rfftn(c, dim=_AXES) for c in (uz, uy, ux)]
    div_over_k2 = (mz * uh[0] + my * uh[1] + mx * uh[2]) * inv
    out = [
        torch.fft.irfftn(c - m * div_over_k2, s=tuple(ux.shape[-3:]), dim=_AXES)
        for c, m in zip(uh, (mz, my, mx))
    ]
    return out[2], out[1], out[0]


def project(u, spacing, scheme: CompactScheme, *, method: str = "auto"):
    """Discrete Helmholtz projection of ``u = (ux, uy, uz)``.

    Returns the divergence-free part of u in the exact discrete sense:
    ``divergence(project(u), spacing, scheme)`` vanishes to rounding.
    ``scheme`` is the periodic d1 scheme ``divergence`` uses; ``method`` is
    ``"auto"``, ``"spectral"`` or ``"compact"`` (module doc).
    """
    _check_periodic(scheme, "project")
    if scheme.derivative_order != 1:
        raise ValueError(
            "project needs the derivative_order=1 scheme divergence uses, "
            f"got derivative_order={scheme.derivative_order}"
        )
    ux, uy, uz = u
    if not (ux.shape == uy.shape == uz.shape) or ux.ndim < 3:
        raise ValueError(
            "project needs three equal-shape [..., nz, ny, nx] components, got "
            f"{[tuple(c.shape) for c in (ux, uy, uz)]}"
        )
    if method not in ("auto", "spectral", "compact"):
        raise ValueError(f"unknown project method {method!r}")
    if method == "auto":
        compact = ux.device.type == "cuda" and ux.dtype == torch.float32 and ux.ndim == 3
        method = "compact" if compact else "spectral"
    if method == "spectral":
        return _project_spectral(ux, uy, uz, scheme, spacing)
    dz, dy, dx = derivatives.spacings3(spacing)
    phi = solve_poisson(derivatives.divergence((ux, uy, uz), spacing, scheme), spacing, scheme)
    px, py = pair.pair_subtract(phi, ux, uy, dy, dx, scheme)
    pz = strided.strided_derivative(phi, -float(dz), scheme, -3, acc=uz)
    return px, py, pz
