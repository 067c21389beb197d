"""Distributed compact derivatives: substructuring over a device mesh.

The port of ``cfd_tpu/parallel/compact.py``. Each shard solves its local
truncated block system, two precomputed unit-load solutions carry the
couplings between shards, and a small reduced interface system gives each
shard its combination weights

    x = x_R + alpha * x_UH + beta * x_LH

* The reduced system is solved redundantly on every shard, from an
  ``all_gather`` of the interface faces over the line's mesh axis, as one
  (2, 2p) product with the shard's rows of the reduced-matrix inverse,
  pivoted at setup in float64, and computed in float64 (the faces are a
  sliver of the field).
* The unit-load systems are solved once at setup in float64.
* Closures at physical ends: the end shards form their closure rows from
  f, in every route (``ops/rhs.shard_rhs``, and K11/K12's ``first``/``last``),
  as the single-device kernels do; only the fast path's interface faces,
  dots of folded stencils over the halo-extended slab, read them through
  ghost rows (``ops/rhs.closure_ghosts``). Halo faces move with one
  ``ppermute`` per direction (``parallel/halo.py``).
* Periodic lines need nothing beyond a cyclic reduced matrix: the corner
  couplings close the ring of blocks.

Routes (``method``), decided per call from the shard shape, dtype and
device exactly as the JAX package decides them, so that each route can be
held against its JAX counterpart:

* the fast path (``"auto"`` on CUDA float32, and ``"kernel"``, where the
  dist kernels take the shard shape: ``ops/dist.lane_dist_supported`` for
  x and y, ``leading_dist_supported`` for z, with the JAX leading kernel's
  ``pick_nb(nl) >= 2`` for ``"auto"``): halos along the native axis, faces
  from truncated functionals, the reduced solve, then one K11 (x) or K12
  (y, z) launch per shard with the interface update in its store; where
  the shards lie on several CUDA devices the solver replays the call from
  one CUDA graph over them (``parallel/graphs.py``);
* the generic route: lines moved to axis 0, halo/ghost rows, the local
  solve by ``"pcr"`` (``"thomas"`` is its alias), ``"matmul"`` (the
  shard's dense ``T_r^{-1}``) or ``"kernel"`` (K12 without the update, the
  JAX package's flat ``_fused_kernel``), then the faces' reduced solve and
  the update; or ``"phipsi"`` (``parallel/phipsi.py``, non-periodic only).
  ``"auto"`` takes ``"matmul"`` for CUDA float32 lines of up to 512
  points and ``"kernel"`` beyond, as the JAX ``resolve_method`` does, and
  ``"pcr"`` for every other dtype and for CPU tensors;
* a mesh axis of one shard: the whole line is on each shard, which runs
  the single-device derivative (K1/K2 through ``ops.derivative``).

On CPU tensors the kernel routes run their plain versions. The fast path
takes float32 only, and raises for float64 with ``"kernel"``, as the JAX
one does. Its faces and every reduced solve run in float64; every float32
dot of the layer (the dense local solve, phi/psi, the plain versions)
checks that float32 products run in full float32
(``ops.dist.require_full_f32``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import derivatives as single
from ..ops import dist, tridiag
from ..ops.rhs import closure_ghosts, shard_rhs
from ..schemes import CompactScheme, lhs_bands
from .dist_tables import pick_nb, shard_blocks, shard_kernel_tables, shard_table
from .graphs import Replays, replayable
from .halo import halo_slices
from .mesh import AXIS_NAMES, Grid, Sharded, all_gather
from .phipsi import phipsi_lines, phipsi_tables

__all__ = ["DistributedCompactSolver", "DirectionTables", "direction_tables", "METHODS"]

METHODS = ("auto", "pcr", "thomas", "kernel", "matmul", "phipsi")
_MATMUL_BLOCK = 512  # JAX resolve_method: f32 lines up to this take the dense operator


@dataclasses.dataclass(frozen=True)
class DirectionTables:
    """Host-precomputed per-rank tables for one decomposed direction.

    All arrays are numpy float64, stacked over the p shards of the line:

    * ``k1, k2, invb``   — PCR tables of each rank's local block, (p, L, nl)
                           and (p, nl)
    * ``tw, tinvd, tdu`` — Thomas tables of the local block, (p, nl) each
    * ``tinv``           — dense inverses of the local blocks, (p, nl, nl)
    * ``uh, lh``         — unit-load secondary solutions, (p, nl)
    * ``rinv_rows``      — own rows of the reduced-matrix inverse, (p, 2, 2p)
    """

    k1: np.ndarray
    k2: np.ndarray
    invb: np.ndarray
    tw: np.ndarray
    tinvd: np.ndarray
    tdu: np.ndarray
    tinv: np.ndarray
    uh: np.ndarray
    lh: np.ndarray
    rinv_rows: np.ndarray


@functools.lru_cache(maxsize=None)
def direction_tables(scheme: CompactScheme, n: int, p: int) -> DirectionTables:
    """All rank-dependent tables of a line of global length ``n`` split
    over ``p`` shards."""
    if n % p:
        raise ValueError(f"global extent {n} not divisible by mesh axis {p}")
    nl = n // p
    if not scheme.periodic and scheme.left_rows:
        widest = max(len(r.rhs_stencil) for r in scheme.left_rows)
        if nl < widest:
            raise ValueError(
                f"local extent {nl} shorter than the closure stencil "
                f"({widest} points) of scheme {scheme.name}; use fewer shards"
            )
    if nl < 2 * scheme.stencil_width + 1:
        raise ValueError(
            f"local extent {nl} too small for stencil width "
            f"{scheme.stencil_width} (need >= {2 * scheme.stencil_width + 1})"
        )
    periodic = scheme.periodic
    alpha = scheme.alpha
    per = {k: [] for k in ("k1", "k2", "invb", "tw", "tinvd", "tdu", "tinv", "uh", "lh")}
    for r in range(p):
        bands = lhs_bands(scheme, nl, first_block=r == 0 and not periodic,
                          last_block=r == p - 1 and not periodic)
        pf = tridiag.pcr_factor(*bands)
        tf = tridiag.thomas_factor(*bands)
        for name, v in (("k1", pf.k1), ("k2", pf.k2), ("invb", pf.invb), ("tw", tf.w),
                        ("tinvd", tf.invd), ("tdu", tf.du)):
            per[name].append(v)
        dl_, d_, du_ = bands
        T = np.diag(d_) + np.diag(dl_[1:], -1) + np.diag(du_[:-1], 1)
        per["tinv"].append(np.linalg.inv(T))
        # unit loads: the coupling of the block's first/last row to its
        # neighbours is the interior off-diagonal alpha; closure rows at
        # physical ends have none. p == 1 periodic is one block coupled to
        # itself: its self-coupling solutions are real there.
        e = np.zeros(nl)
        if periodic or r > 0:
            e[0] = -alpha
            per["uh"].append(tridiag._thomas_solve_np(*bands, e))
            e[0] = 0.0
        else:
            per["uh"].append(np.zeros(nl))
        if periodic or r < p - 1:
            e[-1] = -alpha
            per["lh"].append(tridiag._thomas_solve_np(*bands, e))
        else:
            per["lh"].append(np.zeros(nl))
    uh = np.stack(per["uh"])
    lh = np.stack(per["lh"])

    # the reduced interface matrix over unknowns [alpha_0, beta_0, ...,
    # beta_{p-1}]; entries accumulate (at p == 1 periodic the cyclic
    # neighbour is the block itself)
    m = 2 * p
    R = np.zeros((m, m))
    for r in range(p):
        er, orow = 2 * r, 2 * r + 1
        # even row: -t_r + UH_r^f alpha_r + LH_r^f beta_r = -x_R^f, with
        # t_r = beta_{r-1} (cyclically when periodic)
        R[er, er] += uh[r, 0]
        R[er, orow] += lh[r, 0]
        if r > 0:
            R[er, er - 1] += -1.0
        elif periodic:
            R[er, m - 1] += -1.0
        # odd row: UH_r^l alpha_r + LH_r^l beta_r - t_{r+1} = -x_R^l, with
        # t_{r+1} = alpha_{r+1}
        R[orow, er] += uh[r, -1]
        R[orow, orow] += lh[r, -1]
        if r < p - 1:
            R[orow, orow + 1] += -1.0
        elif periodic:
            R[orow, 0] += -1.0
    if not periodic:
        # physical ends: alpha_0 = 0, beta_{p-1} = 0
        R[0, :] = 0.0
        R[0, 0] = 1.0
        R[m - 1, :] = 0.0
        R[m - 1, m - 1] = 1.0
    if p == 1 and not periodic:
        rinv_rows = np.zeros((1, 2, 2))
    else:
        rinv = np.linalg.inv(R)
        rinv_rows = np.stack([rinv[2 * r : 2 * r + 2, :] for r in range(p)])
    stack = {k: np.stack(per[k]) for k in ("k1", "k2", "invb", "tw", "tinvd", "tdu", "tinv")}
    return DirectionTables(**stack, uh=uh, lh=lh, rinv_rows=rinv_rows)


def _halo_ghosts(x: Sharded, *, scheme: CompactScheme, axis: int, p: int, dim: int = 0):
    """Halo slabs of depth w along ``dim`` from the neighbours on mesh
    ``axis``, closure ghosts at a non-periodic line's physical ends; both
    contiguous. Only the slabs move; the ghosts are built from the end
    shard's two end slabs, moved to axis 0."""
    w = scheme.stencil_width
    left, right = halo_slices(x, AXIS_NAMES[axis], w, scheme.periodic, dim)
    nl = x.local_shape[dim]
    # ghost construction reads at most m rows from each end
    m = max((len(r.rhs_stencil) for r in scheme.left_rows + scheme.right_rows), default=0)
    m = min(nl, max(m, scheme.n_closure + w) + 1)

    def fix(coord, fl, lo, hi):
        rank = coord[axis]
        if not scheme.periodic and rank in (0, p - 1):
            line = fl.movedim(dim, 0)
            gl, gr = closure_ghosts(torch.cat([line[:m], line[nl - m :]]), scheme)
            if rank == 0:
                lo = gl.movedim(0, dim)
            if rank == p - 1:
                hi = gr.movedim(0, dim)
        return lo.contiguous(), hi.contiguous()

    return x.map(fix, left, right, coords=True).unzip()


def _assemble_rhs(lines: Sharded, left: Sharded, right: Sharded, *, scheme, axis, p,
                  inv_dx) -> Sharded:
    """Shard-local compact RHS of lines (nl, *batch): the stencil over the
    halo rows, the closure rows formed from f on the end shards."""
    def rhs(coord, fl, lo, hi):
        rank = coord[axis]
        return shard_rhs(fl, lo, hi, inv_dx, scheme, rank == 0, rank == p - 1)

    return lines.map(rhs, left, right, coords=True)


def _halos(lines: Sharded, *, scheme, axis: int) -> Sharded:
    """The generic route's halo rows of lines (nl, *batch), zeros on a
    non-periodic line's open sides (never read: the end shards form their
    closure rows from f)."""
    left, right = halo_slices(lines, AXIS_NAMES[axis], scheme.stencil_width, scheme.periodic)
    return left.map(torch.Tensor.contiguous), right.map(torch.Tensor.contiguous)


def _phase_local_solve(lines, left, right, *, scheme, axis, p, n, inv_dx, method) -> Sharded:
    """RHS + the local primary solve -> x_R, on lines (nl, *batch)."""
    if method == "kernel":
        blocks = shard_blocks(scheme, n, p)

        def solve(coord, fl, lo, hi):
            nl, w = fl.shape[0], lo.shape[0]
            x = dist.solve_lines_tables(fl.reshape(nl, -1).contiguous(), lo.reshape(w, -1),
                                        hi.reshape(w, -1), inv_dx, blocks[coord[axis]])
            return x.reshape(fl.shape)

        return lines.map(solve, left, right, coords=True)
    rhs = _assemble_rhs(lines, left, right, scheme=scheme, axis=axis, p=p, inv_dx=inv_dx)
    tables = direction_tables(scheme, n, p)
    if method == "matmul":
        def solve(coord, r):
            dist.require_full_f32(r.dtype)
            return torch.tensordot(shard_table(tables, "tinv", coord[axis], r.dtype, r.device),
                                   r, dims=([1], [0]))
    else:
        def solve(coord, r):
            rank = coord[axis]
            fac = tridiag.PCRFactors(*(getattr(tables, k)[rank] for k in ("k1", "k2", "invb")))
            return tridiag.pcr_solve(fac, r)
    return rhs.map(solve, coords=True)


def _reduced_from_faces(face_f: Sharded, face_l: Sharded, tables, *, scheme, axis: int,
                        p: int) -> Sharded:
    """Negate the interface faces (zero at physical ends), all_gather them
    over the line and apply this shard's two rows of the reduced-matrix
    inverse (``tables.rinv_rows``, cached on the shard's device): (2, *batch)
    weights (alpha, beta) per shard, in float64 (the faces are a sliver of
    the field; the weights set every shard boundary)."""
    def stack(coord, ff, fl):
        zero_f = not scheme.periodic and coord[axis] == 0
        zero_l = not scheme.periodic and coord[axis] == p - 1
        return torch.stack([torch.zeros_like(ff) if zero_f else -ff,
                            torch.zeros_like(fl) if zero_l else -fl]).double()

    gathered = all_gather(face_f.map(stack, face_l, coords=True), axis)  # (2p, *batch)

    def solve(coord, g):
        rows = shard_table(tables, "rinv_rows", coord[axis], g.dtype, g.device)
        return (rows @ g.reshape(2 * p, -1)).reshape((2,) + g.shape[1:])

    return gathered.map(solve, coords=True)


def _phase_update(x_r: Sharded, ab: Sharded, tables: DirectionTables, axis: int) -> Sharded:
    """x = x_R + alpha x_UH + beta x_LH on lines (nl, *batch)."""
    def update(coord, x, w):
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        uh = shard_table(tables, "uh", coord[axis], x.dtype, x.device).reshape(shape)
        lh = shard_table(tables, "lh", coord[axis], x.dtype, x.device).reshape(shape)
        w = w.to(x.dtype)
        return x + w[0] * uh + w[1] * lh

    return x_r.map(update, ab, coords=True)


def _dist_lines(lines: Sharded, *, scheme, axis, p, n, inv_dx, method) -> Sharded:
    """Distributed derivative of shard-local lines (nl, *batch) along mesh
    ``axis``: the generic route."""
    left, right = _halos(lines, scheme=scheme, axis=axis)
    if method == "phipsi":
        tables = phipsi_tables(scheme, n, p)  # raises for periodic schemes
        rhs = _assemble_rhs(lines, left, right, scheme=scheme, axis=axis, p=p, inv_dx=inv_dx)
        return phipsi_lines(rhs, tables, axis=axis)
    x_r = _phase_local_solve(lines, left, right, scheme=scheme, axis=axis, p=p, n=n,
                             inv_dx=inv_dx, method=method)
    tables = direction_tables(scheme, n, p)
    ab = _reduced_from_faces(x_r.map(lambda x: x[0]), x_r.map(lambda x: x[-1]), tables,
                             scheme=scheme, axis=axis, p=p)
    return _phase_update(x_r, ab, tables, axis)


def _shard_faces_axis(fl, dim, left, right, fv, *, scheme, inv_dx):
    """Interface faces of the shard-local solve ``x_R = T_r^{-1} rhs`` read
    off the folded truncated functionals ``fv`` (2, K + 2w), float64: one
    dot against the end slab and one against the halo rows each, no local
    solve and no stencil pass. The slabs (~2K/nl of the shard) are taken to
    float64 first: a float32 dot of a derivative's folded weights (whose sum
    is zero) against O(1) values costs ~4e-6 (d1) and ~5e-5 (d2) of
    max|f'| on a smooth field, more than the kernels' own rounding. Two
    float64 tensors of ``fl``'s batch shape, scaled as the kernels' output."""
    w = scheme.stencil_width
    nl = fl.shape[dim]
    K = fv.shape[-1] - 2 * w
    dot = lambda a, v: torch.tensordot(a.double(), v, dims=([dim], [0]))
    if K >= nl:
        ext = torch.cat([left, fl, right], dim)
        f0, f1 = dot(ext, fv[0]), dot(ext, fv[1])
    else:
        # (the JAX package pads the lane slab to 128-lane tiles for the
        # TPU's DMA; zero padding of the vector adds nothing here)
        L = K + w
        f0 = dot(fl.narrow(dim, 0, L), fv[0, w:]) + dot(left, fv[0, :w])
        f1 = dot(fl.narrow(dim, nl - L, L), fv[1, :L]) + dot(right, fv[1, L:])
    scale = float(inv_dx) ** scheme.derivative_order
    return f0 * scale, f1 * scale


def _dist_faces(f: Sharded, left: Sharded, right: Sharded, axis: int, *, scheme, n: int, p: int,
                inv_dx):
    """The fast path's interface faces (face_f, face_l) of every shard, off
    the folded functionals of ``shard_kernel_tables``; each of the shard's
    batch shape (the line axis removed)."""
    skt = shard_kernel_tables(scheme, n, p)
    def faces(coord, fl, lo, hi):
        fv = shard_table(skt, "fv", coord[axis], torch.float64, fl.device)
        return _shard_faces_axis(fl, axis - 3, lo, hi, fv, scheme=scheme, inv_dx=inv_dx)

    return f.map(faces, left, right, coords=True).unzip()


def _dist_kernels(f: Sharded, left: Sharded, right: Sharded, ab: Sharded, axis: int, *,
                  scheme, n: int, p: int, inv_dx) -> Sharded:
    """The fast path's kernel launches: K11 (x) or K12 (y, z) per shard,
    the interface update in the store."""
    blocks = shard_blocks(scheme, n, p)

    def solve(coord, fl, lo, hi, w):
        block = blocks[coord[axis]]
        w = w.to(fl.dtype)
        if axis == 2:
            return dist.lane_dist_derivative(fl, lo, hi, w.movedim(0, -1).contiguous(),
                                             1.0 / inv_dx, block)
        if axis == 1:
            return dist.sublane_dist_derivative(fl, lo, hi, w.movedim(0, -2).contiguous(),
                                                1.0 / inv_dx, block, axis=-2)
        return dist.leading_dist_derivative(fl, lo, hi, w, inv_dx, block)

    return f.map(solve, left, right, ab, coords=True)


def dist_fast(f: Sharded, axis: int, *, scheme: CompactScheme, n: int, p: int, dx) -> Sharded:
    """The fast path's derivative of a field ``(nz, ny, nx)`` per shard along
    mesh ``axis`` (0 = z, 1 = y, 2 = x), ``n`` the global line, ``p`` > 1
    its shards: halos along the native axis, the faces, their all_gather and
    the reduced solve, then the kernels."""
    kw = dict(scheme=scheme, n=n, p=p, inv_dx=1.0 / dx)
    left, right = _halo_ghosts(f, scheme=scheme, axis=axis, p=p, dim=axis - 3)
    faces = _dist_faces(f, left, right, axis, **kw)
    ab = _reduced_from_faces(*faces, shard_kernel_tables(scheme, n, p), scheme=scheme,
                             axis=axis, p=p)
    return _dist_kernels(f, left, right, ab, axis, **kw)


def fast_supported(scheme: CompactScheme, axis: int, nl: int, dtype, *, auto: bool) -> bool:
    """Whether the fast path takes ``nl``-point shard lines along ``axis``:
    the JAX package's conditions (``auto`` adds the leading kernel's
    ``pick_nb(nl) >= 2``)."""
    if axis == 0:
        return dist.leading_dist_supported(scheme, nl, dtype) and (not auto or pick_nb(nl) >= 2)
    return dist.lane_dist_supported(scheme, nl, dtype)


class DistributedCompactSolver:
    """Compact derivatives of fields split in blocks over a device mesh.

    ``method``: ``"auto"``, ``"pcr"`` (``"thomas"`` an alias), ``"kernel"``,
    ``"matmul"`` or ``"phipsi"``; see the module doc for the routes.
    Fields are ``Sharded`` of the grid's global shape (``Grid.distribute``).
    """

    def __init__(self, grid: Grid, *, method: str = "auto"):
        if method not in METHODS:
            raise ValueError(f"method {method!r} is not supported on the distributed path")
        self.grid = grid
        self.method = method
        self._replays = Replays()

    def route(self, f: Sharded, axis: int) -> str:
        """The route a derivative of ``f`` along ``axis`` (0 = z, 1 = y, 2 =
        x) takes: ``"whole"`` (the axis has one shard), ``"fast"``, or the
        generic route's local solve (``"pcr"``, ``"matmul"``, ``"kernel"``,
        ``"phipsi"``)."""
        n, p = self.grid.shape[axis], self.grid.proc_shape[axis]
        nl = n // p
        if p == 1:
            return "whole"
        method = "pcr" if self.method == "thomas" else self.method
        scheme = self.grid.scheme
        if method == "auto":
            if f.dtype != torch.float32 or f.shards[0].device.type != "cuda":
                return "pcr"
            if fast_supported(scheme, axis, nl, f.dtype, auto=True):
                return "fast"
            return "matmul" if nl <= _MATMUL_BLOCK else "kernel"
        if method == "kernel":
            if f.dtype == torch.float64:
                raise ValueError("the distributed kernel path takes float32 only; use "
                                 "method='pcr' for float64 runs")
            if fast_supported(scheme, axis, nl, f.dtype, auto=False):
                return "fast"
        return method

    def _derivative(self, f: Sharded, axis: int) -> Sharded:
        grid = self.grid
        scheme = grid.scheme
        if f.shape != tuple(grid.shape):
            raise ValueError(f"field shape {f.shape} != grid shape {grid.shape}")
        axis = axis % 3
        n, p = grid.shape[axis], grid.proc_shape[axis]
        dx = grid.spacing[axis]
        route = self.route(f, axis)
        if route == "whole":
            # the line is whole on every shard: the single-device derivative
            # (K1/K2 on CUDA float32); the port's single-device path has no
            # PCR, and any direct solve of a whole line is exact
            method = self.method if self.method in ("auto", "kernel", "matmul") else "matmul"
            return f.map(lambda fl: single.derivative(fl, dx, scheme, axis=axis - 3,
                                                      method=method))
        if route == "fast":
            fast = functools.partial(dist_fast, axis=axis, scheme=scheme, n=n, p=p, dx=dx)
            return self._replays(fast, f, axis) if replayable(f) else fast(f)
        lines = f.map(lambda fl: fl.movedim(axis - 3, 0))
        out = _dist_lines(lines, scheme=scheme, axis=axis, p=p, n=n, inv_dx=1.0 / dx,
                          method=route)
        return out.map(lambda x: x.movedim(0, axis - 3).contiguous())

    def apply(self, f: Sharded, axis: int = 2) -> Sharded:
        """Apply the grid's scheme along ``axis`` (0 = z, 1 = y, 2 = x): the
        first or second derivative, or the filter, as its
        ``derivative_order`` says."""
        return self._derivative(f, axis)

    def filter_field(self, f: Sharded) -> Sharded:
        """Filter along all three axes (x, then y, then z); the grid's scheme
        must be a filter (``schemes.get_filter``)."""
        if self.grid.scheme.derivative_order != 0:
            raise ValueError(
                f"grid scheme {self.grid.scheme.name!r} is not a filter; "
                "build the Grid with schemes.get_filter(...)"
            )
        for axis in (2, 1, 0):
            f = self._derivative(f, axis)
        return f

    def dfdx(self, f: Sharded) -> Sharded:
        return self._derivative(f, 2)

    def dfdy(self, f: Sharded) -> Sharded:
        return self._derivative(f, 1)

    def dfdz(self, f: Sharded) -> Sharded:
        return self._derivative(f, 0)

    def gradient(self, f: Sharded):
        return (self.dfdx(f), self.dfdy(f), self.dfdz(f))

    def divergence(self, u) -> Sharded:
        ux, uy, uz = u
        return self.dfdx(ux) + self.dfdy(uy) + self.dfdz(uz)

    def curl(self, u):
        ux, uy, uz = u
        return (
            self.dfdy(uz) - self.dfdz(uy),
            self.dfdz(ux) - self.dfdx(uz),
            self.dfdx(uy) - self.dfdy(ux),
        )
