"""Spectral diagnostics: shell-averaged spectra, enstrophy, dissipation.

The port of ``cfd_tpu/ops/spectra.py``: the turbulence statistics a user of
the incompressible models computes from the fields they evolve. The binning
tables (each rfft mode's shell index and Hermitian multiplicity) are built
once per shape and spacing in float64 numpy and cached, and their tensors
once per device; the device work is one ``torch.fft.rfftn`` per component
and a fixed-order sum into the shells (the JAX package's ``segment_sum``).

Two families:

- **Exact spectral-space statistics** (``energy_spectrum``,
  ``scalar_spectrum``): shell-averaged over the true wavenumber
  ``|k| = sqrt(kx^2 + ky^2 + kz^2)``, normalized so the spectrum sums to
  the physical-space mean (Parseval): ``sum_k E(k) == 0.5 * mean(|u|^2)``.
- **Scheme-consistent physical-space statistics** (``enstrophy``,
  ``dissipation``): through this package's compact ``curl`` and
  ``gradient``, so they measure what the discrete model dissipates; on the
  card they ride K10 and K7 through the normal ``"auto"`` routing.

The shell sum has no atomics: the modes are sorted by shell once (the
cached tables), each shell's run is cut into chunks of ``_CHUNK`` modes,
and two reductions along a fixed axis sum the chunks and then each shell's
chunks. Its order is fixed by the shape alone, so two calls on the same
field give the same bits, on the card as on the CPU (an ``index_add_``
sums with atomics on the card, in an order that changes from run to run).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..schemes import CompactScheme
from .derivatives import curl, gradient, spacings3

__all__ = [
    "spectrum_shells",
    "scalar_spectrum",
    "energy_spectrum",
    "enstrophy",
    "dissipation",
]

_AXES = (-3, -2, -1)


@functools.lru_cache(maxsize=32)
def _shell_tables(shape, spacing):
    """(bins, weights, k_centers) for an rfftn over the last three axes.

    ``bins[z, y, x]`` is the integer shell index of each rfft mode, from
    rounding ``|k| / k_min`` with ``k_min`` the smallest nonzero wavenumber
    over the three axes (isotropic boxes: exactly the fundamental 2*pi/L).
    ``weights`` carries the Hermitian multiplicity of the real transform:
    2 for interior kx columns (each stands for itself and its conjugate),
    1 for the self-conjugate kx = 0 and kx = Nyquist planes.
    """
    nz, ny, nx = shape
    dz, dy, dx = spacing
    kz = 2.0 * np.pi * np.fft.fftfreq(nz, d=dz)
    ky = 2.0 * np.pi * np.fft.fftfreq(ny, d=dy)
    kx = 2.0 * np.pi * np.fft.rfftfreq(nx, d=dx)
    kmag = np.sqrt(kz[:, None, None] ** 2 + ky[None, :, None] ** 2 + kx[None, None, :] ** 2)
    kmin = min(2.0 * np.pi / (n * d) for n, d in ((nz, dz), (ny, dy), (nx, dx)))
    bins = np.rint(kmag / kmin).astype(np.int64)
    weights = np.full(kmag.shape, 2.0)
    weights[..., 0] = 1.0
    if nx % 2 == 0:
        weights[..., -1] = 1.0
    k_centers = kmin * np.arange(int(bins.max()) + 1)
    return bins, weights, k_centers


_CHUNK = 1024  # modes per first-level sum of the shell reduction


@functools.lru_cache(maxsize=32)
def _shell_order(shape, spacing):
    """(gather, chunks), int64: the fixed order of the shell sum.

    ``gather`` (n_chunks * _CHUNK,) lists the flat rfft modes sorted by
    shell, each shell's run padded with the index one past the last mode
    (a zero) to whole chunks; ``chunks`` (n_shells, most chunks of a shell)
    lists each shell's chunks, padded with ``n_chunks`` (a zero)."""
    bins, _, k_centers = _shell_tables(shape, spacing)
    flat = bins.ravel()
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=len(k_centers))
    per_shell = -(-counts // _CHUNK)  # chunks of each shell
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    gather = np.full(int(per_shell.sum()) * _CHUNK, flat.size, np.int64)
    chunks = np.full((len(k_centers), max(int(per_shell.max()), 1)), int(per_shell.sum()), np.int64)
    c0 = 0
    for s, (start, count, nc) in enumerate(zip(starts, counts, per_shell)):
        gather[c0 * _CHUNK : c0 * _CHUNK + count] = order[start : start + count]
        chunks[s, :nc] = np.arange(c0, c0 + nc)
        c0 += nc
    return gather, chunks


@functools.lru_cache(maxsize=16)
def _device_shell_tables(shape, spacing, dtype, device):
    _, weights, k_centers = _shell_tables(shape, spacing)
    gather, chunks = _shell_order(shape, spacing)
    return (torch.as_tensor(gather, device=device), torch.as_tensor(chunks, device=device),
            torch.as_tensor(weights, dtype=dtype, device=device))


def _spacing_key(spacing):
    return tuple(float(s) for s in spacings3(spacing))


def spectrum_shells(shape, spacing) -> np.ndarray:
    """The shell-center wavenumbers ``scalar_spectrum``/``energy_spectrum``
    bin onto for this ``(nz, ny, nx)`` shape and ``(dz, dy, dx)`` spacing
    (float64 numpy, one per shell)."""
    _, _, k_centers = _shell_tables(tuple(int(n) for n in shape[-3:]), _spacing_key(spacing))
    return k_centers


def _shell_power(f: torch.Tensor, spacing) -> torch.Tensor:
    """Shell-summed ``|fhat|^2`` with Hermitian weights, Parseval-normalized
    so the result sums to ``mean(f^2)``: shape ``[n_shells, ...]``."""
    shape = tuple(f.shape[-3:])
    real = torch.float64 if f.dtype == torch.float64 else torch.float32
    gather, chunks, weights = _device_shell_tables(shape, spacing, real, f.device)
    fh = torch.fft.rfftn(f, dim=_AXES)
    power = (fh.real**2 + fh.imag**2) * weights
    batch = f.shape[:-3]
    flat = power.reshape(math.prod(batch), -1) / float(math.prod(shape)) ** 2
    pad = flat.new_zeros((flat.shape[0], 1))
    sums = torch.cat([flat, pad], 1)[:, gather].reshape(flat.shape[0], -1, _CHUNK).sum(-1)
    out = torch.cat([sums, pad], 1)[:, chunks].sum(-1)  # (batch, n_shells)
    return out.T.reshape(chunks.shape[0], *batch)


def scalar_spectrum(f: torch.Tensor, spacing) -> torch.Tensor:
    """Shell-averaged power spectrum of a scalar field.

    ``f`` is ``[..., nz, ny, nx]`` on a periodic box; returns ``P`` with
    ``P[s]`` the power in wavenumber shell ``s`` (centers from
    ``spectrum_shells``), normalized so ``sum(P) == mean(f**2)`` (Parseval).
    Leading batch axes follow the shell axis: shape ``[n_shells, ...]``.
    """
    if f.ndim < 3:
        raise ValueError(f"scalar_spectrum needs [..., nz, ny, nx], got {tuple(f.shape)}")
    return _shell_power(f, _spacing_key(spacing))


def energy_spectrum(u, spacing) -> torch.Tensor:
    """Shell-averaged kinetic-energy spectrum E(k) of ``u = (ux, uy, uz)``.

    ``sum(E) == 0.5 * mean(ux^2 + uy^2 + uz^2)``, the volume-mean kinetic
    energy (``NavierStokes.kinetic_energy``). Shell centers from
    ``spectrum_shells``.
    """
    ux, uy, uz = u
    if not (ux.shape == uy.shape == uz.shape) or ux.ndim < 3:
        raise ValueError(
            "energy_spectrum needs three equal-shape [..., nz, ny, nx] components, got "
            f"{[tuple(c.shape) for c in (ux, uy, uz)]}"
        )
    sp = _spacing_key(spacing)
    return 0.5 * (_shell_power(ux, sp) + _shell_power(uy, sp) + _shell_power(uz, sp))


def enstrophy(u, spacing, scheme: CompactScheme, *, method: str = "auto") -> torch.Tensor:
    """Volume-mean enstrophy ``0.5 * mean(|curl u|^2)`` through the compact
    ``curl`` (K10 and two K2 solves on the card). For periodic
    incompressible fields the dissipation rate is ``2 * nu * enstrophy``."""
    wx, wy, wz = curl(u, spacing, scheme, method=method)
    return 0.5 * torch.mean(wx * wx + wy * wy + wz * wz)


def dissipation(u, spacing, scheme: CompactScheme, nu: float, *,
                method: str = "auto") -> torch.Tensor:
    """Viscous dissipation rate ``nu * mean(sum_ij (du_i/dx_j)^2)`` through
    the compact ``gradient`` (K7 and K2 per component on the card): the rate
    at which the diffusion term of ``models.NavierStokes`` removes kinetic
    energy on a periodic box."""
    total = 0.0
    for comp in u:
        gx, gy, gz = gradient(comp, spacing, scheme, method=method)
        total = total + torch.mean(gx * gx + gy * gy + gz * gz)
    return nu * total
