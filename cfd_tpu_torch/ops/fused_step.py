"""The fused RK3 advection–diffusion substep, and the momentum stage of a
velocity system built on it.

The port of ``cfd_tpu/ops/fused_step.py`` (``make_fused_substep`` and
``make_fused_substep_vec``). One Williamson RK3 substep of
df/dt = -(u . grad f) + nu * lap f, with the compact-d2 Laplacian, is a
head that forms the advection term's xy part and the Laplacian's z
right-hand side, and a tail that does the z work and the update:

    axy, r = head(f, ux, uy)              # axy = ux*fx + uy*fy,
                                          # r = B_z f + T_z (d2x f + d2y f)
    q', f' = tail(f, r, axy, uz, q)       # fz, lap = T_z^{-1} r, the update

where the generic form runs six derivatives and ~15 elementwise passes.
Each part has two routes, chosen per call from the field's shape, dtype and
device, in the JAX package's order:

* head: ``merged_head`` (K3, ``adv_lap_rhs``) where its x phase takes the
  x-lines (``adv_lap.adv_lap_fits``: two staged lines, nx <= 6134); else
  ``stepwise_head`` (K13 ``advection_pair`` + K9 ``lap_rhs``) where both
  are routed there (one x-line within 48 KB, nx <= 12278); else the
  substep returns None and the model runs its generic form;
* tail: ``mega_tail`` (K4, ``rk3_mega``) where ``rk3_mega_supported``;
  else ``stepwise_tail``: K2 with ``mul`` and ``acc`` (``uz * fz + axy``),
  then K2's ``rk`` mode (``rk3_solve_update``). K4 stages a block's
  z-lines in shared memory, so it declines z-lines whose two tiles of one
  column pass the card's opt-in maximum (nz past about 29,000), as the
  JAX package's K4 declines where its VMEM does not fit.

The routes decide on the host, before any launch; a kernel that then fails
raises, and no route catches it. A CPU tensor takes the route that a
float32 field of its shape takes on the card, through the plain versions,
whatever its dtype, but for K4's shared-memory condition, which is the
card's own (``megastep.smem_limit``) and holds only there. On the card a dtype other than float32 has no fused
route: the substeps return None. The change of variables behind ``r`` is
periodic-only (``pallas_lap.py``), so for a non-periodic d2 scheme the
builders return None and the model always runs its generic form.

``make_fused_substep_vec`` is one RK3 stage of all three components of a
velocity (Burgers, Navier–Stokes): K5 (``adv_lap_rhs3``, the three
components in one call) and then K4 per component, advected by the
stage-start velocity, so ``u[2]`` is both the field and ``uz`` of the third
K4 (both read-only). It has no stepwise form, as in the JAX package: where
K5 or K4 does not take the shape it returns None, and the models take the
scalar substep per component.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..schemes import CompactScheme
from . import adv_lap, megastep, pair, strided
from .derivatives import spacings3

__all__ = [
    "make_fused_substep",
    "make_fused_substep_vec",
    "head_route",
    "tail_route",
    "merged_head",
    "stepwise_head",
    "mega_tail",
    "stepwise_tail",
]


def _fusable(scheme: CompactScheme, d2: CompactScheme) -> bool:
    """Whether the fused substeps exist for this pair: raises unless it is a
    d1 and a d2 scheme, and is False for a non-periodic d2 scheme."""
    if scheme.derivative_order != 1:
        raise ValueError(f"scheme {scheme.name!r} must be a first-derivative scheme")
    if d2.derivative_order != 2:
        raise ValueError(f"d2 scheme {d2.name!r} must be a derivative_order=2 scheme")
    return d2.periodic


def _route_dtype(f: torch.Tensor) -> torch.dtype:
    """The dtype a route is decided for: ``f``'s own on the card; float32 on
    the CPU, where every op runs its plain version, so that a CPU run takes
    the route a float32 field of its shape takes on the card."""
    return torch.float32 if f.device.type == "cpu" else f.dtype


def merged_head(f, ux, uy, spacing, scheme: CompactScheme, d2: CompactScheme):
    """``(axy, r)`` from K3 in one call."""
    dz, dy, dx = spacings3(spacing)
    return adv_lap.adv_lap_rhs(f, ux, uy, dz, dy, dx, scheme, d2)


def stepwise_head(f, ux, uy, spacing, scheme: CompactScheme, d2: CompactScheme):
    """``(axy, r)`` from K13 (``advection_pair``) and K9 (``lap_rhs``)."""
    dz, dy, dx = spacings3(spacing)
    return pair.advection_pair(f, ux, uy, dy, dx, scheme), adv_lap.lap_rhs(f, dz, dy, dx, d2)


def head_route(f, scheme: CompactScheme, d2: CompactScheme) -> Optional[Callable]:
    """The head that the substep runs on ``f``: ``merged_head``,
    ``stepwise_head``, or None where neither takes it."""
    dtype = _route_dtype(f)
    if f.ndim != 3 or dtype != torch.float32:
        return None
    nz, ny, nx = f.shape
    if adv_lap.adv_lap_fits(f.shape):
        return merged_head
    if (pair.adv_pair_supported(scheme, ny, nx, dtype)
            and adv_lap.lap_rhs_supported(d2, nz, ny, nx, dtype)):
        return stepwise_head
    return None


def mega_tail(f, r, axy, uz, q, scheme: CompactScheme, d2: CompactScheme, dz,
              *, a, b, dt, nu, last=False):
    """``(q', f')`` from K4 in one call; ``(None, f')`` on the last substep,
    whose q' is dead and never written."""
    return megastep.rk3_mega(f, r, axy, uz, q, scheme, d2, dz,
                             a=a, b=b, dt=dt, nu=nu, write_q=not last)


def stepwise_tail(f, r, axy, uz, q, scheme: CompactScheme, d2: CompactScheme, dz,
                  *, a, b, dt, nu, last=False):
    """``(q', f')`` from K2 in ``mul`` + ``acc`` mode (``uz * fz + axy``) and
    K2's ``rk`` mode; ``(None, f')`` on the last substep."""
    adv = strided.strided_derivative(f, dz, scheme, 0, mul=uz, acc=axy)
    qn, fn = strided.rk3_solve_update(r, adv, q, f, d2, a=a, b=b, dt=dt, nu=nu)
    return (None if last else qn), fn


def tail_route(f, scheme: CompactScheme, d2: CompactScheme) -> Callable:
    """The tail that the substep runs on ``f``: ``mega_tail`` where K4 takes
    it, else ``stepwise_tail``."""
    if megastep.rk3_mega_supported(scheme, d2, f.shape, _route_dtype(f), f.device):
        return mega_tail
    return stepwise_tail


def make_fused_substep(
    spacing, scheme: CompactScheme, d2: CompactScheme
) -> Optional[Callable]:
    """``substep(f, u, q, dt, nu, a, b, last=False) -> (q', f') | None``, or
    None when ``d2`` is not periodic.

    The substep returns None where no head takes ``f`` (the model then runs
    its generic form). ``q=None`` encodes the first substep (a == 0);
    ``last=True`` the final one, where q' is dead: the substep returns
    ``(None, f')``. ``spacing`` is a scalar or (dz, dy, dx).
    """
    if not _fusable(scheme, d2):
        return None
    spacing = spacings3(spacing)

    def substep(f, u, q, dt, nu, a, b, last=False):
        head = head_route(f, scheme, d2)
        if head is None:
            return None
        ux, uy, uz = u
        axy, r = head(f, ux, uy, spacing, scheme, d2)
        tail = tail_route(f, scheme, d2)
        return tail(f, r, axy, uz, q, scheme, d2, spacing[0], a=a, b=b, dt=dt, nu=nu, last=last)

    return substep


def make_fused_substep_vec(
    spacing, scheme: CompactScheme, d2: CompactScheme
) -> Optional[Callable]:
    """``substep_vec(u, q, dt, nu, a, b, last=False) -> (q', u') | None``,
    or None when ``d2`` is not periodic: one momentum stage of all three
    components of ``u = (u0, u1, u2)``.

    The stage returns None where K5 or K4 does not take the components (the
    model then runs the scalar substep per component). ``q`` is a 3-tuple of
    RK states, or None on the first substep; ``last=True`` skips the dead q'
    and returns ``(None, u')``. ``spacing`` is a scalar or (dz, dy, dx).
    """
    if not _fusable(scheme, d2):
        return None
    dz, dy, dx = spacings3(spacing)

    def substep_vec(u, q, dt, nu, a, b, last=False):
        u0 = u[0]
        dtype = _route_dtype(u0)
        if (u0.ndim != 3 or dtype != torch.float32 or not adv_lap.adv_lap3_fits(u0.shape)
                or not megastep.rk3_mega_supported(scheme, d2, u0.shape, dtype, u0.device)):
            return None
        axy, r = adv_lap.adv_lap_rhs3(tuple(u), dz, dy, dx, scheme, d2)
        qs, us = [], []
        for i in range(3):
            qi, ui = mega_tail(u[i], r[i], axy[i], u[2], q[i] if q is not None else None,
                               scheme, d2, dz, a=a, b=b, dt=dt, nu=nu, last=last)
            qs.append(qi)
            us.append(ui)
        return (None if last else tuple(qs)), tuple(us)

    return substep_vec
