"""The fused RK3 advection–diffusion substep: two kernels, no elementwise
passes; and the momentum stage of a velocity system built on it.

The port of ``cfd_tpu/ops/fused_step.py`` (``make_fused_substep`` and
``make_fused_substep_vec``). One
Williamson RK3 substep of df/dt = -(u . grad f) + nu * lap f, with the
compact-d2 Laplacian, is

    axy, r = adv_lap_rhs(f, ux, uy)        # K3: ux*fx + uy*fy, and the
                                           # Laplacian's z right-hand side
    q', f' = rk3_mega(f, r, axy, uz, q)    # K4: dfdz, the z solve, the update

where the generic form runs six derivatives and ~15 elementwise passes.

The JAX substep declines (returns None) at trace time where its TPU kernels
do not serve the shape; of its reasons only one holds on the card: the
change of variables behind ``r`` is periodic-only (``pallas_lap.py``). So
the port decides once, when the bundle is built: ``make_fused_substep``
returns None for a non-periodic d2 scheme, and the model runs its generic
form. The TPU's VMEM budgets and their stepwise fallbacks do not exist
here; on the card a dtype or layout the kernels do not take raises.

``make_fused_substep_vec`` is one RK3 stage of all three components of a
velocity (Burgers, Navier–Stokes): K5 (``adv_lap_rhs3``, the three
components in one call) and then K4 per component, advected by the
stage-start velocity, so ``u[2]`` is both the field and ``uz`` of the third
K4 (both read-only).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..schemes import CompactScheme
from . import adv_lap, megastep
from .derivatives import spacings3

__all__ = ["make_fused_substep", "make_fused_substep_vec"]


def _fusable(scheme: CompactScheme, d2: CompactScheme) -> bool:
    """Whether the fused substeps exist for this pair: raises unless it is a
    d1 and a d2 scheme, and is False for a non-periodic d2 scheme."""
    if scheme.derivative_order != 1:
        raise ValueError(f"scheme {scheme.name!r} must be a first-derivative scheme")
    if d2.derivative_order != 2:
        raise ValueError(f"d2 scheme {d2.name!r} must be a derivative_order=2 scheme")
    return d2.periodic


def make_fused_substep(
    spacing, scheme: CompactScheme, d2: CompactScheme
) -> Optional[Callable]:
    """``substep(f, u, q, dt, nu, a, b, last=False) -> (q', f')``, or None
    when ``d2`` is not periodic.

    ``q=None`` encodes the first substep (a == 0); ``last=True`` the final
    one, where q' is dead: the substep returns ``(None, f')``. ``spacing``
    is a scalar or (dz, dy, dx).
    """
    if not _fusable(scheme, d2):
        return None
    dz, dy, dx = spacings3(spacing)

    def substep(f, u, q, dt, nu, a, b, last=False):
        ux, uy, uz = u
        axy, r = adv_lap.adv_lap_rhs(f, ux, uy, dz, dy, dx, scheme, d2)
        return megastep.rk3_mega(
            f, r, axy, uz, q, scheme, d2, dz,
            a=a, b=b, dt=dt, nu=nu, write_q=not last,
        )

    return substep


def make_fused_substep_vec(
    spacing, scheme: CompactScheme, d2: CompactScheme
) -> Optional[Callable]:
    """``substep_vec(u, q, dt, nu, a, b, last=False) -> (q', u')``, or None
    when ``d2`` is not periodic: one momentum stage of all three components
    of ``u = (u0, u1, u2)``.

    ``q`` is a 3-tuple of RK states, or None on the first substep;
    ``last=True`` skips the dead q' and returns ``(None, u')``. ``spacing``
    is a scalar or (dz, dy, dx).
    """
    if not _fusable(scheme, d2):
        return None
    dz, dy, dx = spacings3(spacing)

    def substep_vec(u, q, dt, nu, a, b, last=False):
        axy, r = adv_lap.adv_lap_rhs3(tuple(u), dz, dy, dx, scheme, d2)
        qs, us = [], []
        for i in range(3):
            qi, ui = megastep.rk3_mega(
                u[i], r[i], axy[i], u[2], q[i] if q is not None else None,
                scheme, d2, dz, a=a, b=b, dt=dt, nu=nu, write_q=not last,
            )
            qs.append(qi)
            us.append(ui)
        return (None if last else tuple(qs)), tuple(us)

    return substep_vec
