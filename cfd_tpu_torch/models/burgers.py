"""3-D viscous Burgers system, the second model family.

The port of ``cfd_tpu/models/burgers.py``. It advances

    du/dt + (u . grad) u = nu * laplacian(u)

for a 3-component velocity with low-storage RK3, every spatial derivative a
compact derivative of this package. The advecting field is the solution
itself, frozen within a stage. A step takes the first route its ``Derivs``
bundle carries that takes the velocity (a fused substep returns None for a
field its kernels do not take; the first call of the step decides, as in
the JAX model):

1. ``fused_substep_vec``: K5 for the three components, then K4 for each
   (4 launches a stage);
2. ``fused_substep``: one scalar fused substep (K3 + K4, or on x-lines too
   long for K3 and K5, K13 + K9 + K4) per component, advected by the
   stage-start velocity;
3. the generic form: ``rhs`` from the bundle's gradient and Laplacian, then
   the RK update in PyTorch.

``NavierStokes`` (``models/navier_stokes.py``) runs the same stages with a
projection after each.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from .advection_diffusion import RK3_A, RK3_B, Derivs

__all__ = ["Burgers"]


class Burgers(nn.Module):
    """Low-storage RK3 stepper for the viscous Burgers system."""

    def __init__(self, derivs: Derivs, nu: float = 1e-2):
        super().__init__()
        self.derivs = derivs
        self.nu = nu

    def rhs(self, u) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-(u . grad) u + nu * laplacian(u), per component."""
        ux, uy, uz = u
        d = self.derivs
        out = []
        for comp in (ux, uy, uz):
            cx, cy, cz = d.gradient(comp)
            adv = ux * cx + uy * cy + uz * cz
            if d.laplacian is not None:
                lap = d.laplacian(comp)
            else:
                lap = d.dfdx(cx) + d.dfdy(cy) + d.dfdz(cz)
            out.append(-adv + self.nu * lap)
        return tuple(out)

    def stages(self, u, dt: float, after_stage: Callable = tuple):
        """One RK3 step, ``after_stage`` applied to the velocity after each
        stage (Navier–Stokes passes its projection)."""
        d = self.derivs
        last = len(RK3_A) - 1
        fsv = d.fused_substep_vec
        first = fsv(u, None, dt, self.nu, RK3_A[0], RK3_B[0]) if fsv is not None else None
        if first is not None:
            q, u = first
            u = after_stage(u)
            for si in range(1, last + 1):
                # q' is dead after the last stage: K4 skips writing it
                q, u = fsv(u, q, dt, self.nu, RK3_A[si], RK3_B[si], last=si == last)
                u = after_stage(u)
            return tuple(u)
        fs = d.fused_substep
        first = fs(u[0], u, None, dt, self.nu, RK3_A[0], RK3_B[0]) if fs is not None else None
        if first is not None:
            q = [None, None, None]
            for si, (a, b) in enumerate(zip(RK3_A, RK3_B)):
                frozen = tuple(u)
                cur = []
                for i in range(3):
                    if si == 0 and i == 0:
                        q[0], ui = first
                    else:
                        q[i], ui = fs(frozen[i], frozen, q[i], dt, self.nu, a, b,
                                      last=si == last)
                    cur.append(ui)
                u = after_stage(tuple(cur))
            return tuple(u)
        q = tuple(torch.zeros_like(c) for c in u)
        for a, b in zip(RK3_A, RK3_B):
            r = self.rhs(u)
            q = tuple(a * qi + dt * ri for qi, ri in zip(q, r))
            u = after_stage(tuple(ui + b * qi for ui, qi in zip(u, q)))
        return tuple(u)

    def step(self, u, dt: float):
        """One low-storage RK3 step."""
        return self.stages(tuple(u), dt)

    def forward(self, u, dt: float):
        return self.step(u, dt)

    def run(self, u0, dt: float, n_steps: int):
        """``n_steps`` RK3 steps."""
        u = tuple(u0)
        for _ in range(n_steps):
            u = self.step(u, dt)
        return u

    def kinetic_energy(self, u) -> torch.Tensor:
        return 0.5 * sum(torch.mean(c * c) for c in u)
