"""The spectral diagnostics (``ops/spectra.py``) against cfd_tpu's.

Inputs are made by numpy from a seed and handed to both packages:

* float64: ``spectrum_shells``, ``scalar_spectrum`` (with a batch axis),
  ``energy_spectrum``, ``enstrophy`` and ``dissipation`` against
  ``cfd_tpu.ops``'s at 1e-10 relative, on an anisotropic box;
* the properties ``tests/test_spectra.py`` states for the JAX package:
  Parseval, a single mode's shell, the Nyquist column's weight, the
  Taylor–Green energy shell and the enstrophy–dissipation identity;
* float32: the spectrum of a float32 field within 1e-6 of max(E) of its
  float64 spectrum (the rfftn and the shell sums round in float32).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu.models as jm
import cfd_tpu.ops as jops
import cfd_tpu.schemes as jsch

import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.models import coordinates, taylor_green
from cfd_tpu_torch.ops import (
    dissipation,
    energy_spectrum,
    enstrophy,
    scalar_spectrum,
    spectrum_shells,
)

F64_TOL = 1e-10
SHAPE = (16, 12, 20)
LENGTHS = (2 * math.pi, 2 * math.pi, 4.0)
SPACING = tuple(L / n for n, L in zip(SHAPE, LENGTHS))


def _velocity(seed=80, shape=SHAPE, lengths=LENGTHS):
    """Taylor–Green plus a seeded smooth perturbation with uz != 0."""
    z, y, x = (np.arange(n) * (L / n) for n, L in zip(shape, lengths))
    u = [np.asarray(c) for c in jm.taylor_green(jnp.asarray(z), jnp.asarray(y), jnp.asarray(x))]
    rng = np.random.default_rng(seed)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    for c in range(3):
        a, b, d = rng.uniform(-0.2, 0.2, 3)
        u[c] = u[c] + a * np.sin(Z + b) * np.cos(2 * np.pi * X / lengths[2] + d) + b * np.cos(Y)
    return u


def _close(got, ref, tol=F64_TOL):
    ref = np.asarray(ref)
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


def test_spectra_float64_match_cfd_tpu():
    u = _velocity()
    np.testing.assert_array_equal(spectrum_shells(SHAPE, SPACING),
                                  jops.spectrum_shells(SHAPE, SPACING))
    f = np.random.default_rng(81).standard_normal((2,) + SHAPE)
    _close(scalar_spectrum(torch.from_numpy(f), SPACING),
           jops.scalar_spectrum(jnp.asarray(f), SPACING))
    _close(energy_spectrum(tuple(torch.from_numpy(c) for c in u), SPACING),
           jops.energy_spectrum(tuple(jnp.asarray(c) for c in u), SPACING))


@pytest.mark.parametrize("name", ["SCHEME4", "SCHEME6_PERIODIC"])
def test_enstrophy_and_dissipation_float64_match_cfd_tpu(name):
    js, ts = getattr(jsch, name), getattr(tsch, name)
    u = _velocity()
    tu, ju = tuple(torch.from_numpy(c) for c in u), tuple(jnp.asarray(c) for c in u)
    _close(enstrophy(tu, SPACING, ts), jops.enstrophy(ju, SPACING, js))
    _close(dissipation(tu, SPACING, ts, 7e-3), jops.dissipation(ju, SPACING, js, 7e-3))


def _grid(n, L=2 * math.pi):
    return coordinates(n, device="cpu", dtype=torch.float64, length=L), L / n


def test_scalar_spectrum_parseval_and_single_mode():
    n = 32
    c, d = _grid(n)
    f = torch.from_numpy(np.random.default_rng(82).standard_normal((n, n, n)))
    assert np.isclose(scalar_spectrum(f, d).sum().item(), (f * f).mean().item(), rtol=1e-12)
    f = torch.sin(3 * c)[None, None, :].expand(n, n, n).contiguous()
    p = scalar_spectrum(f, d)
    idx = int(np.argmin(np.abs(spectrum_shells((n, n, n), d) - 3.0)))
    assert np.isclose(p[idx].item(), 0.5, rtol=1e-12)
    assert abs(p.sum().item() - p[idx].item()) < 1e-14


def test_scalar_spectrum_nyquist_weighting():
    n = 16
    c, d = _grid(n)
    f = torch.cos((n // 2) * c)[None, None, :].expand(n, n, n).contiguous()
    assert np.isclose(scalar_spectrum(f, d).sum().item(), (f * f).mean().item(), rtol=1e-12)


def test_energy_spectrum_taylor_green():
    n = 32
    c, d = _grid(n)
    u = taylor_green(c, c, c)
    E = energy_spectrum(u, d)
    ke = 0.5 * sum((a * a).mean().item() for a in u)
    assert np.isclose(E.sum().item(), ke, rtol=1e-12)
    idx = int(np.argmin(np.abs(spectrum_shells((n, n, n), d) - math.sqrt(3.0))))
    assert E[idx].item() / ke > 0.999


@pytest.mark.parametrize("name", ["SCHEME4_PERIODIC", "SCHEME6_PERIODIC"])
def test_enstrophy_dissipation_identity(name):
    """Taylor–Green: enstrophy 0.5 mean|curl u|^2 = 3/8 to truncation, and
    for this solenoidal field dissipation == 2 nu enstrophy."""
    n = 48
    c, d = _grid(n)
    u = taylor_green(c, c, c)
    scheme = getattr(tsch, name)
    Z = enstrophy(u, d, scheme).item()
    assert np.isclose(Z, 0.375, rtol=1e-4)
    nu = 7e-3
    assert np.isclose(dissipation(u, d, scheme, nu).item(), 2 * nu * Z, rtol=1e-4)


def test_float32_spectrum_within_rounding_of_float64():
    u = _velocity(83)
    E64 = energy_spectrum(tuple(torch.from_numpy(c) for c in u), SPACING)
    E32 = energy_spectrum(tuple(torch.from_numpy(c.astype(np.float32)) for c in u), SPACING)
    assert E32.dtype == torch.float32
    assert (E32.double() - E64).abs().max().item() <= 1e-6 * E64.max().item()


def test_spectra_reject_what_they_do_not_take():
    with pytest.raises(ValueError, match="nz, ny, nx"):
        scalar_spectrum(torch.zeros(4, 4), 0.1)
    with pytest.raises(ValueError, match="equal-shape"):
        energy_spectrum((torch.zeros(4, 4, 4), torch.zeros(4, 4, 4), torch.zeros(4, 4, 5)), 0.1)
