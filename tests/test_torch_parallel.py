"""The port's distributed layer against its single-device path, the
oracles and cfd_tpu's distributed layer.

Inputs are made by numpy from a seed and handed to both packages; the
port's meshes are ``["cpu"] * 8``, the JAX package's the 8 host devices of
``tests/conftest.py``.

* gate 1: the port's ``direction_tables``, ``phipsi_tables`` and shard
  tables equal ``cfd_tpu``'s, 1e-12 of each table's largest entry (both
  are float64 numpy from the same recipe);
* gate 2: the port's ``DistributedCompactSolver`` in float64 (``pcr``,
  ``matmul``, ``phipsi``) against the port's single-device derivative and
  the banded oracle, 1e-10 relative: the same linear system solved by
  another factorisation, so only rounding separates them;
* ``phipsi`` against ``oracle/lanl.py``, 1e-10 relative;
* each route against ``cfd_tpu.DistributedCompactSolver`` on the same
  input: float64 routes at 1e-10; the float32 kernel routes (plain
  versions here) against the JAX Pallas routes in interpret mode at
  2e-6 relative for first derivatives and periodic second derivatives
  (the JAX dist kernels' gate against float64, ``tests/test_dist_kernels.py``),
  and at those kernels' own gates for the others (2e-5 d2 with closures,
  1e-4 filters with closures, 5e-6 periodic filters);
* the mesh: a repeated device, ppermute's open ends, all_gather order,
  Grid's distribute/gather and coordinates, the routes ``auto`` picks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu.ops.tridiag as jtri
import cfd_tpu.parallel as jpar
import cfd_tpu.schemes as jsch
from cfd_tpu.oracle.lanl import lanl_derivative_np as j_lanl
from cfd_tpu.parallel import dist_tables as jdt
from cfd_tpu.parallel.phipsi import phipsi_tables as j_phipsi_tables

import cfd_tpu_torch as ct
import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops import tridiag
from cfd_tpu_torch.oracle import derivative_np, lanl_derivative_np
from cfd_tpu_torch.parallel import (
    DistributedCompactSolver,
    Grid,
    Sharded,
    all_gather,
    direction_tables,
    exchange_3d,
    make_mesh,
    ppermute,
)
from cfd_tpu_torch.parallel import dist_tables as tdt
from cfd_tpu_torch.parallel.phipsi import phipsi_tables

F64_TOL = 1e-10
SPACING = (0.11, 0.13, 0.17)
CPU8 = ["cpu"] * 8


def _pair(name):
    """(cfd_tpu scheme, port scheme) of one name, or of a filter/d2 spec."""
    if name == "filter6":
        return jsch.get_filter(6, periodic=False), tsch.get_filter(6, periodic=False)
    if name == "filter6_periodic":
        return jsch.get_filter(6, periodic=True), tsch.get_filter(6, periodic=True)
    return getattr(jsch, name), getattr(tsch, name)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _field(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape)


# ---------------------------------------------------------------------------
# gate 1: tables
# ---------------------------------------------------------------------------

TABLE_SCHEMES = ["SCHEME4", "SCHEME4_PERIODIC", "SCHEME6", "SCHEME4_D2", "SCHEME6_D2_PERIODIC",
                 "filter6"]


def _same(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("n,p", [(256, 2), (64, 4), (128, 8)])
@pytest.mark.parametrize("name", TABLE_SCHEMES)
def test_tables_equal_cfd_tpu(name, n, p):
    js, ts = _pair(name)
    want, got = jpar.direction_tables(js, n, p), direction_tables(ts, n, p)
    for field in ("k1", "k2", "invb", "tw", "tinvd", "tdu", "tinv", "uh", "lh", "rinv_rows"):
        _same(getattr(got, field), getattr(want, field))
    jk, tk = jdt.shard_kernel_tables(js, n, p), tdt.shard_kernel_tables(ts, n, p)
    assert tk.K == jk.K
    for field in ("suh", "slh", "fv", "rinv_rows"):
        _same(getattr(tk, field), getattr(jk, field))
    assert tdt.pick_nb(n // p) == jdt.pick_nb(n // p)
    nb = tdt.pick_nb(n // p)
    for r, block in enumerate(tdt.shard_blocks(ts, n, p)):
        assert block.first == (r == 0 and not ts.periodic)
        assert block.last == (r == p - 1 and not ts.periodic)
        for field, jfield in (("tinv", "tinv"), ("suh", "uh"), ("slh", "lh")):
            _same(getattr(block, field), getattr(want, jfield)[r])
        # one sub-block is the whole block: its factors are the block's
        whole = tdt.local_block_tables(ts, n // p, block.first, block.last, 1)
        for field, jfield in (("w", "tw"), ("invd", "tinvd"), ("du", "tdu")):
            _same(getattr(whole, field), getattr(want, jfield)[r])
        sub = tdt.local_block_tables(ts, n // p, block.first, block.last, nb)
        for got_t, want_t in zip(sub, jdt.local_block_tables(js, n // p, block.first,
                                                             block.last, nb)):
            _same(got_t, want_t)
    if not ts.periodic:
        jp, tp = j_phipsi_tables(js, n, p), phipsi_tables(ts, n, p)
        for field in ("linv", "uinv", "psi", "eta", "yrow", "xrow"):
            _same(getattr(tp, field), getattr(jp, field))


@pytest.mark.parametrize("method", ["pcr", "thomas"])
@pytest.mark.parametrize("n", [37, 64])
def test_tridiag_factors_and_solves_match_cfd_tpu(n, method):
    """PCR and Thomas tables equal cfd_tpu's (1e-12); the acyclic solves and
    the cyclic one (over a Thomas core) along either axis match its solves
    on the same RHS (1e-12)."""
    rhs = np.random.default_rng(2).standard_normal((n, 3, 5))
    bands = tsch.lhs_bands(tsch.SCHEME6, n)
    for got, want in zip(tridiag.factor(*bands, method), jtri.factor(*bands, method)):
        _same(got, want)
    periodic = tsch.lhs_bands(tsch.SCHEME6_PERIODIC, n)
    alpha = tsch.SCHEME6_PERIODIC.alpha
    cases = ((tridiag.factor(*bands, method), jtri.factor(*bands, method)),
             (tridiag.cyclic_factor(*periodic, alpha, alpha),
              jtri.cyclic_factor(*periodic, alpha, alpha, "thomas")))
    for ours, theirs in cases:
        for axis in (0, 1):
            r = np.moveaxis(rhs, 0, axis)
            got = tridiag.solve(ours, torch.from_numpy(np.ascontiguousarray(r)), axis)
            _same(got, jtri.solve(theirs, jnp.asarray(r), axis))


def test_phipsi_tables_reject_periodic():
    with pytest.raises(ValueError, match="non-periodic"):
        phipsi_tables(tsch.SCHEME4_PERIODIC, 64, 2)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_make_mesh_repeats_devices_and_never_falls_back():
    mesh = make_mesh((2, 2, 2), devices=CPU8)
    assert mesh.shape == (2, 2, 2) and mesh.size == 8
    assert all(mesh.device(c) == torch.device("cpu") for c in mesh.coords())
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((2, 2, 2), devices=["cpu"] * 4)
    if not torch.cuda.is_available():  # no CUDA devices: the default raises
        with pytest.raises(ValueError, match="needs 1 devices, have 0"):
            make_mesh((1, 1, 1))


def test_grid_distribute_gather_and_coordinates():
    shape = (8, 12, 16)
    mesh = make_mesh((2, 3, 4), devices=["cpu"] * 24)
    grid = Grid(mesh, shape, SPACING, tsch.SCHEME4)
    assert grid.local_shape == (4, 4, 4)
    f = _field(shape)
    fs = grid.distribute(f)
    assert fs.shape == shape and fs.local_shape == (4, 4, 4)
    assert np.array_equal(grid.gather(fs), f)
    assert np.array_equal(fs[(1, 2, 3)].numpy(), f[4:, 8:, 12:])
    for ax, c in enumerate(grid.coordinates(dtype=torch.float64)):
        for coord in mesh.coords():
            n = grid.local_shape[ax]
            want = np.arange(coord[ax] * n, (coord[ax] + 1) * n) * SPACING[ax]
            np.testing.assert_allclose(c[coord].numpy(), want, rtol=1e-15)
    with pytest.raises(ValueError, match="not divisible"):
        Grid(mesh, (8, 12, 15), SPACING)
    twice = (fs * 2.0 - fs) + (-fs) + 3.0 * fs
    assert np.allclose(grid.gather(twice), 3.0 * f)


def test_collectives():
    mesh = make_mesh((1, 1, 4), devices=["cpu"] * 4)
    x = Sharded(mesh, [torch.full((2,), float(c[2])) for c in mesh.coords()])
    right = ppermute(x, "x", 1, periodic=False)
    assert [t[0].item() for t in right.shards] == [0.0, 0.0, 1.0, 2.0]
    wrap = ppermute(x, "x", -1, periodic=True)
    assert [t[0].item() for t in wrap.shards] == [1.0, 2.0, 3.0, 0.0]
    gathered = all_gather(x, 2)
    assert all(t.tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0] for t in gathered.shards)


def test_exchange_3d_matches_a_padded_field():
    """Six-face exchange with periodic axes equals the whole field padded
    by wrapping, cut into the same extended blocks (edges and corners
    included)."""
    shape = (4, 6, 8)
    mesh = make_mesh((2, 2, 2), devices=CPU8)
    grid = Grid(mesh, shape, SPACING)
    f = torch.from_numpy(_field(shape))
    ext = exchange_3d(grid.distribute(f), width=1, periodic=(True, True, True))
    padded = torch.from_numpy(np.pad(f.numpy(), 1, mode="wrap"))
    for c in mesh.coords():
        lo = [ci * n for ci, n in zip(c, grid.local_shape)]
        want = padded[lo[0]:lo[0] + 4, lo[1]:lo[1] + 5, lo[2]:lo[2] + 6]
        assert torch.equal(ext[c], want)


# ---------------------------------------------------------------------------
# gate 2: float64 routes against the single-device path and the oracles
# ---------------------------------------------------------------------------

GATE2_CASES = [
    # (mesh, shape): every axis sharded; a z line over 8 shards; x over 2
    ((2, 2, 2), (32, 16, 24)),
    ((8, 1, 1), (256, 8, 16)),
    ((1, 1, 2), (8, 16, 64)),
]
GATE2_SCHEMES = ["SCHEME4", "SCHEME4_PERIODIC", "SCHEME6", "SCHEME4_D2", "SCHEME6_D2_PERIODIC",
                 "filter6", "filter6_periodic"]


GATE2_ROUTES = [(name, method) for name in GATE2_SCHEMES for method in ("pcr", "matmul", "phipsi")
                if not (method == "phipsi" and "PERIODIC" in name.upper())]


@pytest.mark.parametrize("name,method", GATE2_ROUTES)
@pytest.mark.parametrize("mesh_shape,shape", GATE2_CASES, ids=["2x2x2", "8x1x1", "1x1x2"])
def test_float64_routes_match_single_device_and_oracle(mesh_shape, shape, name, method):
    _, scheme = _pair(name)
    f = _field(shape)
    grid = Grid(make_mesh(mesh_shape, devices=CPU8), shape, SPACING, scheme)
    solver = DistributedCompactSolver(grid, method=method)
    fs = grid.distribute(torch.from_numpy(f))
    for axis in range(3):
        got = grid.gather(solver.apply(fs, axis))
        single = ct.derivative(torch.from_numpy(f), SPACING[axis], scheme, axis=axis,
                               method="matmul").numpy()
        assert _rel(got, single) < F64_TOL
        assert _rel(got, derivative_np(scheme, f, SPACING[axis], axis=axis)) < F64_TOL


@pytest.mark.parametrize("name", ["SCHEME4", "SCHEME6", "SCHEME4_D2"])
def test_phipsi_matches_lanl_oracle(name):
    js, scheme = _pair(name)
    shape = (64, 8, 16)
    f = _field(shape, seed=3)
    grid = Grid(make_mesh((4, 1, 1), devices=["cpu"] * 4), shape, SPACING, scheme)
    got = grid.gather(DistributedCompactSolver(grid, method="phipsi").dfdz(grid.distribute(f)))
    want = lanl_derivative_np(scheme, f, SPACING[0], nblocks=4, axis=0)
    assert _rel(got, want) < F64_TOL
    assert _rel(want, j_lanl(js, f, SPACING[0], nblocks=4, axis=0)) < F64_TOL


# ---------------------------------------------------------------------------
# each route against cfd_tpu's distributed solver
# ---------------------------------------------------------------------------

F32_GATES = {
    "SCHEME4": 2e-6, "SCHEME4_PERIODIC": 2e-6, "SCHEME4_D2_PERIODIC": 2e-6,
    "SCHEME4_D2": 2e-5, "filter6": 1e-4, "filter6_periodic": 5e-6,
}


def _jax_solver(js, mesh_shape, shape, method, **kw):
    grid = jpar.Grid(jpar.make_mesh(mesh_shape), shape, SPACING, js)
    return jpar.DistributedCompactSolver(grid, method=method, **kw)


def _jit(fn, *args):
    """One JAX call, traced whole: eager shard_map dispatch costs ~10x the
    compile on the CPU."""
    return jax.jit(fn)(*args)


@pytest.mark.parametrize("name,method", [
    ("SCHEME4", "pcr"), ("SCHEME4", "thomas"), ("SCHEME4", "matmul"), ("SCHEME4", "phipsi"),
    ("SCHEME4_PERIODIC", "pcr"), ("SCHEME4_PERIODIC", "matmul"), ("SCHEME4_D2", "phipsi"),
])
def test_float64_routes_match_cfd_tpu(name, method):
    js, scheme = _pair(name)
    mesh_shape, shape = (2, 2, 2), (32, 16, 24)
    f = _field(shape, seed=11)
    grid = Grid(make_mesh(mesh_shape, devices=CPU8), shape, SPACING, scheme)
    fs = grid.distribute(f)
    got = DistributedCompactSolver(grid, method=method).gradient(fs)
    want = _jit(_jax_solver(js, mesh_shape, shape, method).gradient, jnp.asarray(f))
    for g, w in zip(got, want):
        assert _rel(grid.gather(g), w) < F64_TOL


KERNEL_CASES = [
    # (mesh, shape, axis, schemes): the fast path along each axis (the lane
    # form needs 128-point shard lines), and the generic kernel route
    # (row 8) where the shard lines are too short for the fast path
    ((1, 1, 2), (8, 16, 256), 2),
    ((1, 2, 1), (8, 256, 128), 1),
    ((8, 1, 1), (256, 8, 128), 0),
    ((1, 1, 4), (4, 8, 256), 2),
]


@pytest.mark.parametrize("name", list(F32_GATES))
@pytest.mark.parametrize("mesh_shape,shape,axis", KERNEL_CASES,
                         ids=["x-fast", "y-fast", "z-fast", "x-lines"])
def test_kernel_routes_match_cfd_tpu_pallas(mesh_shape, shape, axis, name):
    """float32 on the kernel routes: the port's plain versions against the
    JAX Pallas kernels in interpret mode, and both against float64."""
    js, scheme = _pair(name)
    f = _field(shape, seed=5)
    grid = Grid(make_mesh(mesh_shape, devices=CPU8), shape, SPACING, scheme)
    solver = DistributedCompactSolver(grid, method="kernel")
    fs = grid.distribute(torch.from_numpy(f.astype(np.float32)))
    want_route = "kernel" if shape == (4, 8, 256) else "fast"
    assert solver.route(fs, axis) == want_route
    got = grid.gather(solver.apply(fs, axis))
    jsolver = _jax_solver(js, mesh_shape, shape, "pallas", interpret=True)
    want = np.asarray(_jit(lambda g: jsolver.apply(g, axis), jnp.asarray(f, jnp.float32)),
                      np.float64)
    exact = derivative_np(scheme, f, SPACING[axis], axis=axis)
    gate = F32_GATES[name]
    assert _rel(want, exact) < gate
    assert _rel(got, exact) < gate
    assert _rel(got, want) < 2 * gate


def test_routes_auto_picks():
    """``auto``: pcr for CPU tensors and float64; the whole-axis branch on
    an unsharded axis; the kernel route raises for float64."""
    shape = (32, 16, 256)
    grid = Grid(make_mesh((2, 1, 2), devices=["cpu"] * 4), shape, SPACING, tsch.SCHEME4)
    f32 = grid.distribute(torch.zeros(shape))
    auto = DistributedCompactSolver(grid)
    assert [auto.route(f32, a) for a in range(3)] == ["pcr", "whole", "pcr"]
    kernel = DistributedCompactSolver(grid, method="kernel")
    assert [kernel.route(f32, a) for a in range(3)] == ["fast", "whole", "fast"]
    with pytest.raises(ValueError, match="float32 only"):
        kernel.dfdx(grid.distribute(torch.zeros(shape, dtype=torch.float64)))
    with pytest.raises(ValueError, match="not supported"):
        DistributedCompactSolver(grid, method="pallas")
    with pytest.raises(ValueError, match="!= grid shape"):
        auto.dfdx(Grid(grid.mesh, (32, 16, 128), SPACING).distribute(torch.zeros(32, 16, 128)))


def test_vector_calculus_and_filter_field():
    """gradient, divergence, curl and filter_field on the mesh against the
    single-device functions, float64."""
    shape = (16, 16, 24)
    mesh = make_mesh((2, 2, 2), devices=CPU8)
    u = [_field(shape, seed=s) for s in (1, 2, 3)]
    grid = Grid(mesh, shape, SPACING, tsch.SCHEME4_PERIODIC)
    solver = DistributedCompactSolver(grid)
    us = [grid.distribute(c) for c in u]
    ut = [torch.from_numpy(c) for c in u]
    spacing = SPACING
    for got, want in zip(solver.gradient(us[0]), ct.gradient(ut[0], spacing, tsch.SCHEME4_PERIODIC)):
        assert _rel(grid.gather(got), want) < F64_TOL
    assert _rel(grid.gather(solver.divergence(us)),
                ct.divergence(ut, spacing, tsch.SCHEME4_PERIODIC)) < F64_TOL
    for got, want in zip(solver.curl(us), ct.curl(ut, spacing, tsch.SCHEME4_PERIODIC)):
        assert _rel(grid.gather(got), want) < F64_TOL
    filt = tsch.get_filter(6, periodic=False)
    fgrid = Grid(mesh, shape, SPACING, filt)
    got = DistributedCompactSolver(fgrid).filter_field(us[0])
    assert _rel(fgrid.gather(got), ct.filter_field(ut[0], filt)) < F64_TOL
    with pytest.raises(ValueError, match="not a filter"):
        solver.filter_field(us[0])
