"""The plain reference of what the cells compute, in PyTorch.

Built from ``schemes.py``'s coefficients alone; it imports nothing of the
program. Two precisions:

- ``FLOAT64``: the reference that decides ``correct``;
- ``TF32``: the control, the same arithmetic in float32 with every
  operator's operands (the field and, for a matrix product, the operator)
  rounded to TF32's 10-bit mantissa first, as the tensor cores round them.
  The rounding is done here, bit by bit, so the control is the same on any
  device.

The periodic operators (the Navier-Stokes cells) act in Fourier space: a
periodic compact operator is circulant, so the DFT diagonalises it exactly
and ``d1_symbol``/``d2_symbol`` are its eigenvalues. The bounded line's
first derivative (the dfdx cells) is the dense ``T^{-1} B`` applied by a
matrix product, a block of lines at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from .schemes import d1_matrix, d1_symbol, d2_symbol

__all__ = ["Precision", "FLOAT64", "TF32", "tf32_round", "Periodic", "RK3_A", "RK3_B",
           "bounded_d1", "bounded_d1_apply", "bounded_d1_gap"]

# Williamson's low-storage RK3 (J. Comput. Phys. 35:48, 1980)
RK3_A = (0.0, -5.0 / 9.0, -153.0 / 128.0)
RK3_B = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)

_AXES = (-3, -2, -1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa bits,
    ties to even), as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + (0x0FFF + ((bits >> 13) & 1))) & ~0x1FFF
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    real: torch.dtype
    round: Callable[[torch.Tensor], torch.Tensor]

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return self.round(x.to(self.real))


FLOAT64 = Precision("float64", torch.float64, lambda x: x)
TF32 = Precision("tf32", torch.float32, tf32_round)


def _no_tf32() -> None:
    # a float32 product must stay float32 (the control rounds by hand)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Periodic:
    """The periodic box's operators, spectral and exact to rounding: the 4th-
    order Pade first and second derivatives, the Helmholtz projection that
    zeroes their divergence, one Navier-Stokes RK3 step and the
    diagnostics."""

    def __init__(self, shape: Sequence[int], h: float, prec: Precision, device):
        self.shape = tuple(int(n) for n in shape)
        self.h = float(h)
        self.prec = prec
        nz, ny, nx = self.shape
        theta = [2 * np.pi * np.fft.fftfreq(nz), 2 * np.pi * np.fft.fftfreq(ny),
                 2 * np.pi * np.fft.rfftfreq(nx)]
        put = lambda a, s: torch.as_tensor(a.reshape(s), dtype=prec.real, device=device)
        shapes = ((-1, 1, 1), (1, -1, 1), (1, 1, -1))
        self.m1 = [put(d1_symbol(t) / self.h, s) for t, s in zip(theta, shapes)]
        self.m2 = [put(d2_symbol(t) / self.h**2, s) for t, s in zip(theta, shapes)]
        k2 = sum(m * m for m in self.m1)
        self.inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
        self.lap = -(self.m2[0] + self.m2[1] + self.m2[2])
        # shells (|k| over the fundamental, rounded) and Hermitian weights of
        # the energy spectrum
        kmag = np.sqrt(theta[0][:, None, None] ** 2 + theta[1][None, :, None] ** 2
                       + theta[2][None, None, :] ** 2) / self.h
        kmin = 2 * np.pi / (max(self.shape) * self.h)
        self.bins = torch.as_tensor(np.rint(kmag / kmin).astype(np.int64).reshape(-1),
                                    device=device)
        w = torch.full(kmag.shape, 2.0, dtype=prec.real, device=device)
        w[..., 0] = 1.0
        if nx % 2 == 0:
            w[..., -1] = 1.0
        self.weights = w

    def fft(self, f: torch.Tensor) -> torch.Tensor:
        return torch.fft.rfftn(self.prec.operand(f), dim=_AXES)

    def ifft(self, fh: torch.Tensor) -> torch.Tensor:
        return torch.fft.irfftn(fh, s=self.shape, dim=_AXES)

    def grad_hat(self, fh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(df/dz, df/dy, df/dx) from ``fh``, the transform of f."""
        return tuple(self.ifft(1j * m * fh) for m in self.m1)

    def gradient(self, f):
        """(df/dx, df/dy, df/dz)."""
        gz, gy, gx = self.grad_hat(self.fft(f))
        return gx, gy, gz

    def project(self, u):
        """The part of ``u = (ux, uy, uz)`` whose compact divergence is 0."""
        uh = [self.fft(c) for c in (u[2], u[1], u[0])]  # z, y, x
        div_k2 = (self.m1[0] * uh[0] + self.m1[1] * uh[1] + self.m1[2] * uh[2]) * self.inv_k2
        out = [self.ifft(c - m * div_k2) for c, m in zip(uh, self.m1)]
        return out[2], out[1], out[0]

    def divergence(self, u):
        return sum(self.gradient(c)[i] for i, c in enumerate(u))

    def rhs(self, u, nu: float):
        """-(u . grad) u_i + nu lap u_i, each component."""
        out = []
        for c in u:
            ch = self.fft(c)
            gz, gy, gx = self.grad_hat(ch)
            lap = self.ifft(self.lap * ch)
            out.append(nu * lap - (u[0] * gx + u[1] * gy + u[2] * gz))
        return out

    def step(self, u, dt: float, nu: float):
        """One Williamson RK3 step, the projection after each stage."""
        u = tuple(c.to(self.prec.real) for c in u)
        q = None
        for a, b in zip(RK3_A, RK3_B):
            r = self.rhs(u, nu)
            q = [dt * ri if qi is None else a * qi + dt * ri
                 for qi, ri in zip(q or (None,) * 3, r)]
            u = self.project(tuple(ui + b * qi for ui, qi in zip(u, q)))
        return u

    def kinetic_energy(self, u) -> torch.Tensor:
        return 0.5 * sum(torch.mean(self.prec.operand(c) ** 2) for c in u)

    def enstrophy(self, u) -> torch.Tensor:
        (ux_x, ux_y, ux_z), (uy_x, uy_y, uy_z), (uz_x, uz_y, uz_z) = (self.gradient(c) for c in u)
        w = (uz_y - uy_z, ux_z - uz_x, uy_x - ux_y)
        return 0.5 * sum(torch.mean(c * c) for c in w)

    def dissipation(self, u, nu: float) -> torch.Tensor:
        return nu * sum(torch.mean(g * g) for c in u for g in self.gradient(c))

    def energy_spectrum(self, u) -> torch.Tensor:
        """E(k) on integer shells ``round(|k| / k_min)``, summing to the mean
        kinetic energy (Parseval)."""
        n = math.prod(self.shape)
        power = sum((self.fft(c).abs() ** 2) * self.weights for c in u)
        out = torch.zeros(int(self.bins.max()) + 1, dtype=power.dtype, device=power.device)
        out.index_add_(0, self.bins, power.reshape(-1))
        return 0.5 * out / float(n) ** 2


def bounded_d1(n: int, h: float, prec: Precision, device) -> torch.Tensor:
    """The bounded line's first-derivative operator, an (n, n) tensor."""
    return prec.operand(torch.as_tensor(d1_matrix(n, h), device=device))


def _blocks(f: torch.Tensor, axis: int, block: int):
    # index tuples of blocks of planes along an axis the derivative does not
    # run along, so that a block's product fits beside the program's arrays
    cut = 1 if axis % 3 == 0 else 0
    for s in range(0, f.shape[cut], block):
        idx = [slice(None)] * 3
        idx[cut] = slice(s, s + block)
        yield tuple(idx)


def _apply(d: torch.Tensor, fb: torch.Tensor, axis: int) -> torch.Tensor:
    axis %= 3
    if axis == 2:
        return fb @ d.T
    if axis == 1:
        return d @ fb
    return torch.einsum("ij,jyx->iyx", d, fb)


def bounded_d1_apply(f: torch.Tensor, d: torch.Tensor, axis: int, prec: Precision,
                     block: int = 32) -> torch.Tensor:
    """``D f`` along ``axis`` of the (nz, ny, nx) field ``f`` in ``prec``,
    with ``d`` from ``bounded_d1``."""
    _no_tf32()
    out = torch.empty(f.shape, dtype=prec.real, device=f.device)
    for idx in _blocks(f, axis, block):
        out[idx] = _apply(d, prec.operand(f[idx]), axis)
    return out


def bounded_d1_gap(f: torch.Tensor, got: torch.Tensor, d: torch.Tensor, axis: int,
                   block: int = 32) -> Tuple[float, float]:
    """(max |got - D f|, max |D f|) along ``axis``, ``D f`` in float64 with
    ``d = bounded_d1(n, h, FLOAT64, device)``."""
    _no_tf32()
    gap = top = 0.0
    for idx in _blocks(f, axis, block):
        ref = _apply(d, FLOAT64.operand(f[idx]), axis)
        gap = max(gap, float((got[idx].to(torch.float64) - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
    return gap, top
