"""The distributed fused RK3 substep and the distributed gradient.

The port of ``cfd_tpu/parallel/fused.py``. One Williamson RK3 substep of
df/dt = -(u . grad f) + nu * lap f with the compact-d2 Laplacian, on a
field split over a mesh:

  fx, d2x   — the x derivatives: the fast path (halos, faces, reduced
              solve, one K11 launch per shard, ``parallel/compact.py``), or
              the single-device kernels where x is whole on every shard
  fy, d2y   — the same along y (K12)
  z whole   — ``axy = ux fx + uy fy`` and the Laplacian's z right-hand
  (pz = 1)    side ``r = B_z f + T_z (d2x + d2y)`` (cyclic z stencils,
              elementwise), then K4 ``rk3_mega`` shard-locally: fz, the z
              solve T_z^{-1} r and the update
  z sharded — fz and d2z through the fast path (K12 along z), then the
              Williamson update ``q' = a q + dt (nu lap - adv); f' = f +
              b q'`` elementwise (the reference's 2x2x2 topology)

The maker decides once, when the bundle is built, whether the substep
exists for the grid, as the port's single-device maker does: periodic d1
and d2 schemes (the change of variables behind ``r`` is periodic-only),
and every sharded axis of a shard shape the dist kernels take (the JAX
package's ``lane_dist_supported``/``leading_dist_supported`` with
``pick_nb >= 2``). Otherwise it returns None and the model runs its
generic step. On CPU tensors every kernel runs its plain version.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import derivatives as single
from ..ops import megastep, pair
from .compact import DistributedCompactSolver, dist_fast, fast_supported
from .mesh import Sharded

__all__ = ["make_fused_substep_distributed", "make_gradient_distributed"]


def make_fused_substep_distributed(
    solver: DistributedCompactSolver, d2_solver: DistributedCompactSolver
) -> Optional[Callable]:
    """``substep(f, u, q, dt, nu, a, b, last=False) -> (q', f')`` over the
    solvers' grid, or None where the fused substep does not apply (see the
    module doc). ``q=None`` encodes the first substep; ``last=True``
    returns ``(None, f')``."""
    grid = solver.grid
    scheme, d2 = grid.scheme, d2_solver.grid.scheme
    if scheme.derivative_order != 1 or d2.derivative_order != 2:
        raise ValueError("need a d1 scheme solver and a d2 scheme solver")
    if not (scheme.periodic and d2.periodic):
        return None
    dz, dy, dx = grid.spacing
    pz, py, px = grid.proc_shape
    nz, ny, nx = grid.shape
    f32 = torch.float32
    for axis, n, p in ((2, nx, px), (1, ny, py), (0, nz, pz)):
        if p > 1 and not all(fast_supported(s, axis, n // p, f32, auto=True) for s in (scheme, d2)):
            return None
    z_whole = pz == 1

    def axis_deriv(f: Sharded, axis: int, sch) -> Sharded:
        n, p, d = grid.shape[axis], grid.proc_shape[axis], grid.spacing[axis]
        if p == 1:  # whole axis on every shard: the single-device kernels
            return f.map(lambda fl: single.derivative(fl, d, sch, axis=axis - 3))
        return dist_fast(f, axis, scheme=sch, n=n, p=p, dx=d)

    def z_rhs(fl, acc):
        """r = B_z f / dz^2 + T_z acc with cyclic z stencils (z whole)."""
        rz = sum(wk * (torch.roll(fl, -k, 0) + torch.roll(fl, k, 0))
                 for k, wk in zip(d2.rhs_offsets, d2.rhs_weights))
        if d2.rhs_center:
            rz = rz + d2.rhs_center * fl
        return rz / (dz * dz) + acc + d2.alpha * (torch.roll(acc, -1, 0) + torch.roll(acc, 1, 0))

    def substep(f, u, q, dt, nu, a, b, last=False):
        ux, uy, uz = u
        fx = axis_deriv(f, 2, scheme)
        fy = axis_deriv(f, 1, scheme)
        d2x = axis_deriv(f, 2, d2)
        d2y = axis_deriv(f, 1, d2)
        if not z_whole:
            fz = axis_deriv(f, 0, scheme)
            d2z = axis_deriv(f, 0, d2)
            qn = dt * (nu * (d2x + d2y + d2z) - (ux * fx + uy * fy + uz * fz))
            if q is not None:
                qn = a * q + qn
            return (None if last else qn), f + b * qn
        axy = ux * fx + uy * fy
        r = f.map(z_rhs, d2x + d2y)

        def tail(fl, rl, axyl, uzl, *ql):
            return megastep.rk3_mega(fl, rl, axyl, uzl, ql[0] if ql else None, scheme, d2, dz,
                                     a=a, b=b, dt=dt, nu=nu, write_q=not last)

        qn, fn = f.map(tail, r, axy, uz, *((q,) if q is not None else ())).unzip()
        return (None if last else qn), fn

    return substep


def make_gradient_distributed(solver: DistributedCompactSolver) -> Callable:
    """The distributed gradient ``f -> (fx, fy, fz)``: on meshes where x and
    y are whole (z pencils) and the field is CUDA float32, (fx, fy) come
    from one K7 launch per shard (``ops/pair.gradient_pair``) and fz from
    the solver, as the JAX package takes its pair kernel; otherwise three
    solver calls."""
    grid = solver.grid
    scheme = grid.scheme
    pz, py, px = grid.proc_shape
    dz, dy, dx = grid.spacing
    nz, ny, nx = grid.shape

    def gradient(f: Sharded):
        if (py == px == 1 and f.shards[0].device.type == "cuda"
                and pair.pair_supported(scheme, ny, nx, f.dtype)):
            fx, fy = f.map(lambda fl: pair.gradient_pair(fl, dy, dx, scheme)).unzip()
            return fx, fy, solver.dfdz(f)
        return solver.dfdx(f), solver.dfdy(f), solver.dfdz(f)

    return gradient
