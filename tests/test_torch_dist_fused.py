"""The distributed RK3 advection–diffusion model (``Derivs.distributed``)
against the port's single-device model and cfd_tpu's distributed model.

Taylor–Green velocity, f0 = sin x, SCHEME4_PERIODIC with the compact d2
Laplacian (SCHEME4_D2_PERIODIC), the port's meshes ``["cpu"] * n``. On the
CPU every kernel runs its plain version. Two meshes take the two branches
of the distributed fused substep: (1, 2, 2) leaves z whole (the fast path
along x and y, then K4's plain version shard-locally), (2, 1, 1) shards z
(the fast path along z, the update elementwise). The JAX models are
stepped eagerly under ``jax.jit`` of one step (``run``'s ``lax.scan``
takes minutes to compile on the CPU).

Tolerances, relative to max|f|:

* float64, 5 steps of the fused distributed model against the port's
  single-device generic model (dense operators): 1e-10. The fast path's
  interface faces are truncated at 1e-9 of the inverse rows' largest entry
  (``parallel/dist_tables.py``), far below this after the solve;
* float64, 2 steps against cfd_tpu's distributed model (its generic step
  off the TPU, PCR local solves): 1e-10;
* float32, 5 steps against the float64 single-device model: 1e-5, and 1e-3
  of what the steps changed (``chip_smoke.py``'s slice gates);
* float32, one substep against cfd_tpu's distributed fused substep with
  its Pallas kernels in interpret mode: 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu.models as jm
import cfd_tpu.parallel as jpar
import cfd_tpu.schemes as jsch
from cfd_tpu.parallel.fused import make_fused_substep_distributed as j_make_substep

import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.models import AdvectionDiffusion, Derivs, sine_field, taylor_green
from cfd_tpu_torch.ops import dist, lane, megastep, strided
from cfd_tpu_torch.parallel import DistributedCompactSolver, Grid, make_mesh

DT = 1e-3
NU = 0.05  # the diffusion moves f well past the float32 gate in 5 steps
CASES = {"z-whole": ((1, 2, 2), (8, 256, 256)), "z-sharded": ((2, 1, 1), (128, 16, 16))}


def _spacing(shape):
    return tuple(2 * math.pi / n for n in shape)


def _state(shape, dtype=np.float64):
    """(f0, (ux, uy, uz)) as numpy: sin x and Taylor–Green."""
    z, y, x = (torch.arange(n, dtype=torch.float64) * (2 * math.pi / n) for n in shape)
    f0 = sine_field(z, y, x)[0]
    u = taylor_green(z, y, x)
    return f0.numpy().astype(dtype), tuple(c.numpy().astype(dtype) for c in u)


def _port(mesh_shape, shape, method="auto"):
    mesh = make_mesh(mesh_shape, devices=["cpu"] * math.prod(mesh_shape))
    g1 = Grid(mesh, shape, _spacing(shape), tsch.SCHEME4_PERIODIC)
    g2 = Grid(mesh, shape, _spacing(shape), tsch.SCHEME4_D2_PERIODIC)
    derivs = Derivs.distributed(DistributedCompactSolver(g1, method=method),
                                DistributedCompactSolver(g2, method=method))
    return g1, AdvectionDiffusion(derivs, nu=NU)


def _single(shape, dtype):
    derivs = Derivs.single_device(_spacing(shape), tsch.SCHEME4_PERIODIC, "matmul",
                                  second_derivative=True)
    f0, u = _state(shape)
    tt = lambda a: torch.from_numpy(a).to(dtype)
    return AdvectionDiffusion(derivs, nu=NU), tt(f0), tuple(tt(c) for c in u)


def _rel(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("case", list(CASES))
def test_fused_model_float64_matches_single_device(case):
    mesh_shape, shape = CASES[case]
    grid, model = _port(mesh_shape, shape)
    assert model.derivs.fused_substep is not None
    f0, u = _state(shape)
    f = model.run(grid.distribute(f0), tuple(grid.distribute(c) for c in u), DT, 5)
    ref_model, rf0, ru = _single(shape, torch.float64)
    ref = ref_model.run(rf0, ru, DT, 5).numpy()
    assert _rel(grid.gather(f), ref) < 1e-10


@pytest.mark.parametrize("case", list(CASES))
def test_fused_model_float32_matches_float64(case):
    mesh_shape, shape = CASES[case]
    grid, model = _port(mesh_shape, shape)
    f0, u = _state(shape, np.float32)
    before = (dict(dist.LAUNCHES), lane.LAUNCHES, strided.LAUNCHES, megastep.LAUNCHES)
    f = grid.gather(model.run(grid.distribute(f0), tuple(grid.distribute(c) for c in u), DT, 5))
    assert before == (dict(dist.LAUNCHES), lane.LAUNCHES, strided.LAUNCHES, megastep.LAUNCHES)
    assert f.dtype == np.float32 and np.isfinite(f).all()
    ref_model, rf0, ru = _single(shape, torch.float64)
    ref = ref_model.run(rf0, ru, DT, 5).numpy()
    err = np.abs(f - ref).max()
    assert err / np.abs(ref).max() < 1e-5
    assert err / np.abs(ref - rf0.numpy()).max() < 1e-3


def _jax_model(mesh_shape, shape, **kw):
    mesh = jpar.make_mesh(mesh_shape)
    solvers = [jpar.DistributedCompactSolver(jpar.Grid(mesh, shape, _spacing(shape), s), **kw)
               for s in (jsch.SCHEME4_PERIODIC, jsch.SCHEME4_D2_PERIODIC)]
    return jm.AdvectionDiffusion(jm.Derivs.distributed(*solvers), nu=NU), solvers


@pytest.mark.parametrize("case", list(CASES))
def test_model_float64_matches_cfd_tpu(case):
    """Two steps: the port's fused distributed step against cfd_tpu's
    distributed step (its generic form off the TPU)."""
    mesh_shape, shape = CASES[case]
    grid, model = _port(mesh_shape, shape)
    f0, u = _state(shape)
    f = model.run(grid.distribute(f0), tuple(grid.distribute(c) for c in u), DT, 2)
    jmodel, _ = _jax_model(mesh_shape, shape)
    step = jax.jit(lambda f, u: jmodel.step(f, u, DT))
    jf, ju = jnp.asarray(f0), tuple(jnp.asarray(c) for c in u)
    for _ in range(2):
        jf = step(jf, ju)
    assert _rel(grid.gather(f), np.asarray(jf)) < 1e-10


def test_generic_model_matches_cfd_tpu():
    """The distributed generic step (no d2 solver: the repeated first
    derivative; the solver's PCR route) against cfd_tpu's, float64."""
    mesh_shape, shape = (2, 2, 2), (16, 16, 32)
    mesh = make_mesh(mesh_shape, devices=["cpu"] * 8)
    grid = Grid(mesh, shape, _spacing(shape), tsch.SCHEME4_PERIODIC)
    model = AdvectionDiffusion(Derivs.distributed(DistributedCompactSolver(grid)), nu=NU)
    assert model.derivs.fused_substep is None and model.derivs.laplacian is None
    f0, u = _state(shape)
    f = model.step(grid.distribute(f0), tuple(grid.distribute(c) for c in u), DT)
    jgrid = jpar.Grid(jpar.make_mesh(mesh_shape), shape, _spacing(shape), jsch.SCHEME4_PERIODIC)
    jmodel = jm.AdvectionDiffusion(jm.Derivs.distributed(jpar.DistributedCompactSolver(jgrid)),
                                   nu=NU)
    jf = jax.jit(lambda f, u: jmodel.step(f, u, DT))(jnp.asarray(f0),
                                                    tuple(jnp.asarray(c) for c in u))
    assert _rel(grid.gather(f), np.asarray(jf)) < 1e-10


def test_substep_float32_matches_cfd_tpu_pallas_interpret():
    """One middle substep on the z-sharded mesh: the port's plain versions
    against cfd_tpu's distributed fused substep, Pallas in interpret mode."""
    mesh_shape, shape = CASES["z-sharded"]
    grid, model = _port(mesh_shape, shape)
    rng = np.random.default_rng(4)
    f0, u = _state(shape, np.float32)
    q = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
    a, b = -5.0 / 9.0, 15.0 / 16.0
    qs, fs = model.derivs.fused_substep(grid.distribute(f0), tuple(grid.distribute(c) for c in u),
                                        grid.distribute(q), DT, NU, a, b)
    _, solvers = _jax_model(mesh_shape, shape)
    jsub = j_make_substep(*solvers, interpret=True)
    jq, jf = jax.jit(lambda f, u, q: jsub(f, u, q, DT, NU, a, b))(
        jnp.asarray(f0), tuple(jnp.asarray(c) for c in u), jnp.asarray(q))
    assert _rel(grid.gather(fs), np.asarray(jf, np.float64)) < 1e-5
    assert _rel(grid.gather(qs), np.asarray(jq, np.float64)) < 1e-5


def test_fused_substep_declines_where_the_kernels_do_not_apply():
    """None (the model's generic step) for non-periodic schemes and for
    shard shapes the dist kernels do not take, as the JAX substep declines."""
    mesh = make_mesh((1, 1, 4), devices=["cpu"] * 4)
    shape = (8, 16, 256)  # x shards of 64 points: not a multiple of 128
    sp = _spacing(shape)
    solvers = [DistributedCompactSolver(Grid(mesh, shape, sp, s))
               for s in (tsch.SCHEME4_PERIODIC, tsch.SCHEME4_D2_PERIODIC)]
    assert Derivs.distributed(*solvers).fused_substep is None
    walls = [DistributedCompactSolver(Grid(make_mesh((1, 1, 2), devices=["cpu"] * 2),
                                           (8, 16, 256), sp, s))
             for s in (tsch.SCHEME4, tsch.SCHEME4_D2)]
    assert Derivs.distributed(*walls).fused_substep is None
    with pytest.raises(ValueError, match="derivative_order=2"):
        Derivs.distributed(solvers[0], solvers[0])
