"""Scalar advection–diffusion stepper, the flagship pipeline.

The port of ``cfd_tpu/models/advection_diffusion.py``. It advances

    df/dt = -(u . grad f) + nu * laplacian(f)

with low-storage RK3 (Williamson coefficients), every spatial derivative a
compact derivative of this package. The diffusion term is the compact
second-derivative ``laplacian`` when the ``Derivs`` bundle carries one
(``second_derivative=True``), and the repeated first derivative
``dfdx(fx) + dfdy(fy) + dfdz(fz)`` otherwise. The generic step is 3
substeps x (3 first derivatives + the diffusion term) plus PyTorch's
elementwise tail. With a periodic d2 scheme and ``method="auto"`` the
bundle also carries the fused substep (``ops/fused_step.py``): two kernels
per substep, K3 and K4, and no elementwise passes; on x-lines too long for
K3 (6135 <= nx <= 12278) three, K13 + K9 + K4. Where no fused head takes
the field, the substep returns None and the step runs its generic form, as
the JAX model does. ``Derivs.distributed``
runs the same model on fields split over a device mesh
(``parallel.Sharded``), with the distributed fused substep
(``parallel/fused.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..ops import derivatives as single
from ..ops.fused_step import make_fused_substep, make_fused_substep_vec
from ..schemes import SCHEME4_PERIODIC, CompactScheme, get_scheme

__all__ = ["AdvectionDiffusion", "Derivs", "state_from_numpy", "tensors_from_numpy"]

# Williamson low-storage RK3
RK3_A = (0.0, -5.0 / 9.0, -153.0 / 128.0)
RK3_B = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)


@dataclasses.dataclass(frozen=True)
class Derivs:
    """A (dfdx, dfdy, dfdz) bundle.

    ``gradient`` (f -> (fx, fy, fz)) evaluates the three first derivatives
    of the advection term. ``laplacian``, when set, is the diffusion
    operator (compact second derivatives); when None the model
    differentiates the gradient once more. ``fused_substep``, when set, is
    ``(f, u, q, dt, nu, a, b, last) -> (q', f')``, one whole RK3 substep
    (``ops/fused_step.py``), which the model's step then runs instead of
    its generic form. ``fused_substep_vec``, when set, is
    ``(u, q, dt, nu, a, b, last) -> (q', u')``, one momentum stage of all
    three components of a velocity, which Burgers and Navier–Stokes prefer.
    Either returns None for a field its kernels do not take; the model then
    takes its next form, decided on the first call of each step.
    """

    dfdx: Callable
    dfdy: Callable
    dfdz: Callable
    gradient: Callable
    laplacian: Optional[Callable] = None
    fused_substep: Optional[Callable] = None
    fused_substep_vec: Optional[Callable] = None

    @classmethod
    def single_device(
        cls,
        spacing,
        scheme: CompactScheme = SCHEME4_PERIODIC,
        method: str = "auto",
        second_derivative: bool = False,
    ):
        """Bundle over ``ops.derivatives``; ``spacing`` is a scalar or
        (dz, dy, dx).

        ``second_derivative=True`` adds a compact-d2 ``laplacian`` of the
        same order and periodicity as ``scheme`` and, for ``method="auto"``
        and a first-derivative ``scheme``, the fused substeps (scalar and
        vector), which exist for periodic schemes only.
        """
        dz, dy, dx = single.spacings3(spacing)
        lap = None
        fused = fused_vec = None
        if second_derivative:
            d2 = get_scheme(scheme.order, scheme.periodic, derivative=2)
            lap = lambda f: single.laplacian(f, (dz, dy, dx), d2, method=method)
            if method == "auto" and scheme.derivative_order == 1:
                fused = make_fused_substep((dz, dy, dx), scheme, d2)
                fused_vec = make_fused_substep_vec((dz, dy, dx), scheme, d2)
        return cls(
            dfdx=lambda f: single.dfdx(f, dx, scheme, method=method),
            dfdy=lambda f: single.dfdy(f, dy, scheme, method=method),
            dfdz=lambda f: single.dfdz(f, dz, scheme, method=method),
            gradient=lambda f: single.gradient(f, (dz, dy, dx), scheme, method=method),
            laplacian=lap,
            fused_substep=fused,
            fused_substep_vec=fused_vec,
        )

    @classmethod
    def distributed(cls, solver, d2_solver=None):
        """Bundle over a ``parallel.DistributedCompactSolver``: fields are
        ``parallel.Sharded``.

        ``d2_solver``, a solver over the same grid geometry with a
        second-derivative scheme, adds the ``laplacian`` (the sum of its
        three axis derivatives) and, for a first-derivative ``solver``, the
        distributed fused substep (``parallel/fused.py``; None where it does
        not apply). ``gradient`` takes K7 per shard on z-pencil meshes.
        """
        from ..parallel.fused import make_fused_substep_distributed, make_gradient_distributed

        lap = fused = None
        if d2_solver is not None:
            if d2_solver.grid.scheme.derivative_order != 2:
                raise ValueError("d2_solver must carry a derivative_order=2 scheme")
            lap = lambda f: d2_solver.dfdx(f) + d2_solver.dfdy(f) + d2_solver.dfdz(f)
            if solver.grid.scheme.derivative_order == 1:
                fused = make_fused_substep_distributed(solver, d2_solver)
        return cls(
            dfdx=solver.dfdx,
            dfdy=solver.dfdy,
            dfdz=solver.dfdz,
            gradient=make_gradient_distributed(solver),
            laplacian=lap,
            fused_substep=fused,
        )


class AdvectionDiffusion(nn.Module):
    """RK3 advection–diffusion of a scalar by a frozen velocity field."""

    def __init__(self, derivs: Derivs, nu: float = 1e-3):
        super().__init__()
        self.derivs = derivs
        self.nu = nu

    def rhs(self, f, u):
        ux, uy, uz = u
        d = self.derivs
        fx, fy, fz = d.gradient(f)
        adv = ux * fx + uy * fy + uz * fz
        if d.laplacian is not None:
            lap = d.laplacian(f)
        else:
            lap = d.dfdx(fx) + d.dfdy(fy) + d.dfdz(fz)
        return -adv + self.nu * lap

    def step(self, f, u, dt: float):
        """One low-storage RK3 step; ``f`` and ``u`` are tensors, or
        ``parallel.Sharded`` with a distributed bundle."""
        fs = self.derivs.fused_substep
        if fs is not None:
            # the first substep has no q (a == 0); a None result says that
            # no fused head takes f: the generic form below runs instead
            out = fs(f, u, None, dt, self.nu, RK3_A[0], RK3_B[0])
            if out is not None:
                q, fc = out
                last = len(RK3_A) - 1
                for i in range(1, last + 1):
                    # q' is dead after the last substep: the tail skips it
                    q, fc = fs(fc, u, q, dt, self.nu, RK3_A[i], RK3_B[i], last=i == last)
                return fc
        q = None  # the first substep has no q (a == 0)
        for a, b in zip(RK3_A, RK3_B):
            q = dt * self.rhs(f, u) if q is None else a * q + dt * self.rhs(f, u)
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


def tensors_from_numpy(arrays, device, dtype=torch.float32):
    """A tuple of tensors on ``device`` from numpy arrays: a JAX run's
    velocity triple or RK state (``np.asarray`` of its arrays)."""
    # np.array copies: a JAX array's numpy view is read-only
    return tuple(torch.from_numpy(np.array(a)).to(device=device, dtype=dtype) for a in arrays)


def state_from_numpy(f: np.ndarray, u, device, dtype=torch.float32):
    """(f, (ux, uy, uz)) as tensors on ``device``, from numpy arrays.

    Carries a JAX run's state (``np.asarray`` of its arrays) onto the port.
    """
    (f,) = tensors_from_numpy((f,), device, dtype)
    return f, tensors_from_numpy(u, device, dtype)
