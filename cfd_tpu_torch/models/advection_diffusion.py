"""Scalar advection–diffusion stepper, the flagship pipeline.

The port of ``cfd_tpu/models/advection_diffusion.py``. It advances

    df/dt = -(u . grad f) + nu * laplacian(f)

with low-storage RK3 (Williamson coefficients), every spatial derivative a
compact first derivative of this package. The diffusion term is the
repeated first derivative ``dfdx(fx) + dfdy(fy) + dfdz(fz)``: the port has
no second-derivative scheme path and no fused substep yet, so a step is
3 substeps x 6 single-axis derivatives plus PyTorch's elementwise tail.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..ops import derivatives as single
from ..schemes import SCHEME4_PERIODIC, CompactScheme

__all__ = ["AdvectionDiffusion", "Derivs", "state_from_numpy"]

# Williamson low-storage RK3
RK3_A = (0.0, -5.0 / 9.0, -153.0 / 128.0)
RK3_B = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)


@dataclasses.dataclass(frozen=True)
class Derivs:
    """A (dfdx, dfdy, dfdz) bundle.

    ``gradient`` (f -> (fx, fy, fz)) evaluates the three first derivatives
    of the advection term; the model differentiates them once more for the
    diffusion term. ``laplacian`` is the place of a second-derivative
    diffusion operator, which the port does not have yet: it stays None.
    """

    dfdx: Callable
    dfdy: Callable
    dfdz: Callable
    gradient: Callable
    laplacian: Optional[Callable] = None

    @classmethod
    def single_device(
        cls, spacing, scheme: CompactScheme = SCHEME4_PERIODIC, method: str = "auto"
    ):
        """First-derivative bundle over ``ops.derivatives``.

        ``spacing`` is a scalar or (dz, dy, dx).
        """
        dz, dy, dx = single.spacings3(spacing)
        return cls(
            dfdx=lambda f: single.dfdx(f, dx, scheme, method=method),
            dfdy=lambda f: single.dfdy(f, dy, scheme, method=method),
            dfdz=lambda f: single.dfdz(f, dz, scheme, method=method),
            gradient=lambda f: single.gradient(f, (dz, dy, dx), scheme, method=method),
        )


class AdvectionDiffusion(nn.Module):
    """RK3 advection–diffusion of a scalar by a frozen velocity field."""

    def __init__(self, derivs: Derivs, nu: float = 1e-3):
        super().__init__()
        self.derivs = derivs
        self.nu = nu

    def rhs(self, f: torch.Tensor, u) -> torch.Tensor:
        ux, uy, uz = u
        d = self.derivs
        fx, fy, fz = d.gradient(f)
        adv = ux * fx + uy * fy + uz * fz
        lap = d.dfdx(fx) + d.dfdy(fy) + d.dfdz(fz)
        return -adv + self.nu * lap

    def step(self, f: torch.Tensor, u, dt: float) -> torch.Tensor:
        """One low-storage RK3 step."""
        q = torch.zeros_like(f)
        for a, b in zip(RK3_A, RK3_B):
            q = a * q + dt * self.rhs(f, u)
            f = f + b * q
        return f

    def forward(self, f: torch.Tensor, u, dt: float) -> torch.Tensor:
        return self.step(f, u, dt)

    def run(self, f0: torch.Tensor, u, dt: float, n_steps: int) -> torch.Tensor:
        """``n_steps`` RK3 steps."""
        f = f0
        for _ in range(n_steps):
            f = self.step(f, u, dt)
        return f


def state_from_numpy(f: np.ndarray, u, device, dtype=torch.float32):
    """(f, (ux, uy, uz)) as tensors on ``device``, from numpy arrays.

    Carries a JAX run's state (``np.asarray`` of its arrays) onto the port.
    """
    def put(a):
        # np.array copies: a JAX array's numpy view is read-only
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    return put(f), tuple(put(c) for c in u)
