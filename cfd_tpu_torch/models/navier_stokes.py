"""Incompressible Navier–Stokes on a periodic box, the third model family.

The port of ``cfd_tpu/models/navier_stokes.py`` (single device; the
distributed form is not ported yet). It advances

    du/dt + (u . grad) u = -grad p + nu * laplacian(u),   div u = 0

by a fractional step: each Williamson RK3 stage is one Burgers stage
(``models/burgers.py``, its three routes), and the stage velocity is then
made discretely divergence-free by the Helmholtz projection
(``ops/poisson.project``). Periodic compact operators are circulant, so the
projection annihilates the compact divergence this package computes to
rounding: after every stage, ``divergence(u)`` is zero to rounding.

On a CUDA float32 (nz, ny, nx) field with ``method="auto"`` a step is
three times: K5, K4 for each component, then the compact projection (K6
and K2's solve for the divergence, the FFT Poisson solve, ``pair_subtract``
and K2 with ``acc`` for ``u - grad phi``). On x-lines too long for K5
(6135 <= nx <= 12278) each component's stage is K13 + K9 + K4 instead.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import derivatives as single
from ..ops.poisson import project, solve_poisson
from ..schemes import SCHEME4_PERIODIC, CompactScheme
from .advection_diffusion import Derivs
from .burgers import Burgers

__all__ = ["NavierStokes"]


class NavierStokes(nn.Module):
    """RK3 fractional-step solver for incompressible Navier–Stokes.

    ``derivs`` supplies the momentum stages' operators; ``scheme`` is the
    periodic d1 scheme whose divergence the projection annihilates;
    ``spacing`` is (dz, dy, dx); ``method`` the derivative method of the
    divergence (``"auto"`` or ``"matmul"``).
    """

    def __init__(self, derivs: Derivs, spacing, scheme: CompactScheme = SCHEME4_PERIODIC,
                 nu: float = 1e-3, method: str = "auto"):
        super().__init__()
        if not scheme.periodic or scheme.derivative_order != 1:
            raise ValueError(
                "NavierStokes needs a periodic derivative_order=1 scheme for the "
                f"projection; got {scheme.name!r}"
            )
        self.momentum = Burgers(derivs, nu)
        self.spacing = single.spacings3(spacing)
        self.scheme = scheme
        self.nu = nu
        self.method = method

    @classmethod
    def single_device(cls, spacing, scheme: CompactScheme = SCHEME4_PERIODIC,
                      nu: float = 1e-3, method: str = "auto") -> "NavierStokes":
        """Build with the single-device bundle: the compact-d2 viscous
        Laplacian and, on ``"auto"``, the fused substeps."""
        derivs = Derivs.single_device(spacing, scheme, method=method, second_derivative=True)
        return cls(derivs, spacing, scheme, nu, method)

    @property
    def derivs(self) -> Derivs:
        return self.momentum.derivs

    def project(self, u):
        """Discrete Helmholtz projection of a velocity field."""
        return project(tuple(u), self.spacing, self.scheme)

    def divergence(self, u) -> torch.Tensor:
        """The compact divergence the projection annihilates."""
        return single.divergence(tuple(u), self.spacing, self.scheme, method=self.method)

    def pressure(self, u) -> torch.Tensor:
        """Diagnostic pressure, zero mean: div(grad p) = -div((u . grad) u).

        For a solenoidal u the viscous term is divergence-free discretely
        (the circulant operators commute), so only advection sources p.
        """
        ux, uy, uz = u
        adv = []
        for comp in (ux, uy, uz):
            cx, cy, cz = self.derivs.gradient(comp)
            adv.append(ux * cx + uy * cy + uz * cz)
        rhs = -self.divergence(tuple(adv))
        return solve_poisson(rhs - rhs.mean(), self.spacing, self.scheme)

    def kinetic_energy(self, u) -> torch.Tensor:
        return self.momentum.kinetic_energy(u)

    def step(self, u, dt: float):
        """One RK3 step: three (momentum stage, projection) pairs. The
        projected velocity advects the next stage."""
        return self.momentum.stages(tuple(u), dt, after_stage=self.project)

    def forward(self, u, dt: float):
        return self.step(u, dt)

    def run(self, u0, dt: float, n_steps: int):
        """``n_steps`` RK3 steps."""
        u = tuple(u0)
        for _ in range(n_steps):
            u = self.step(u, dt)
        return u
