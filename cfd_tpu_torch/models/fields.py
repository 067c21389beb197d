"""Analytic test fields on tensors.

The port of ``cfd_tpu/models/fields.py``: the reference's sin and
x cos(xy) + sin(z) y fields and the Taylor–Green vortex, 3-D and 2-D. Each function
takes 1-D coordinate tensors (z, y, x) and returns ``(nz, ny, nx)``
tensors on their device; ``coordinates`` makes those on an explicit
device.
"""

from __future__ import annotations

import math

import torch

__all__ = ["coordinates", "benchmark_field", "taylor_green", "taylor_green_2d", "sine_field"]


def coordinates(
    n: int, *, device, dtype=torch.float32, length: float = 2 * math.pi
) -> torch.Tensor:
    """``n`` points ``i * length / n`` of a periodic box, on ``device``."""
    c = torch.arange(n, dtype=torch.float64, device=device) * (length / n)
    return c.to(dtype)


def _meshgrid3(z, y, x):
    return z[:, None, None], y[None, :, None], x[None, None, :]


def _full(t, z, y, x):
    return t.expand(len(z), len(y), len(x)).contiguous()


def benchmark_field(z, y, x):
    """f = x cos(xy) + sin(z) y and its exact gradient (dfdx, dfdy, dfdz)."""
    Z, Y, X = _meshgrid3(z, y, x)
    f = X * torch.cos(X * Y) + torch.sin(Z) * Y
    dfdx = torch.cos(X * Y) - X * Y * torch.sin(X * Y)
    dfdy = -(X**2) * torch.sin(X * Y) + torch.sin(Z)
    dfdz = torch.cos(Z) * Y
    return _full(f, z, y, x), tuple(_full(g, z, y, x) for g in (dfdx, dfdy, dfdz))


def taylor_green(z, y, x, t: float = 0.0, nu: float = 0.0):
    """Taylor–Green vortex velocity (ux, uy, uz) on a periodic box.

    u = cos(x) sin(y) sin(z) F(t), v = -sin(x) cos(y) sin(z) F(t), w = 0,
    with F(t) = exp(-2 nu t).
    """
    Z, Y, X = _meshgrid3(z, y, x)
    F = math.exp(-2.0 * nu * t)
    u = torch.cos(X) * torch.sin(Y) * torch.sin(Z) * F
    v = -torch.sin(X) * torch.cos(Y) * torch.sin(Z) * F
    return u, v, torch.zeros_like(u)


def taylor_green_2d(z, y, x, t: float = 0.0, nu: float = 0.0):
    """The z-independent Taylor–Green vortex, an exact Navier–Stokes
    solution: u = cos(x) sin(y) F, v = -sin(x) cos(y) F, w = 0 and
    p = -(cos 2x + cos 2y) F^2 / 4, with F(t) = exp(-2 nu t).

    Returns ((u, v, w), p).
    """
    Z, Y, X = _meshgrid3(z, y, x)
    F = math.exp(-2.0 * nu * t)
    u = _full(torch.cos(X) * torch.sin(Y) * F, z, y, x)
    v = _full(-torch.sin(X) * torch.cos(Y) * F, z, y, x)
    p = _full(-(torch.cos(2 * X) + torch.cos(2 * Y)) * (F * F / 4), z, y, x)
    return (u, v, torch.zeros_like(u)), p


def sine_field(z, y, x, k: float = 1.0):
    """f = sin(k x) over (z, y) and its exact d/dx = k cos(k x)."""
    X = x[None, None, :]
    return _full(torch.sin(k * X), z, y, x), _full(k * torch.cos(k * X), z, y, x)
