"""The closure rows of the generic distributed routes, against the float64
oracle.

A non-periodic line's end shards form their closure rows from f
(``ops/rhs.shard_rhs``), as K11/K12 and the single-device kernels do, and
every row is formed from differences to its own value. The case is a
second derivative along x of ``sin x + cos y + sin 2z`` at 64^3 on a
(1, 1, 4) mesh (16-point shard lines), where the closure LHS's corner
amplifies rounding in the RHS ~700x:

* float32, each generic route (``pcr``, ``matmul``, ``phipsi``,
  ``kernel``) against the float64 dense derivative: within 2x of the
  single-device float32 dense solve of the same field, which reads only
  the input's rounding through the operator (2.5e-4 of max|f''| for
  SCHEME4_D2, 5.8e-4 for SCHEME6_D2). Formed from the raw values with
  float32 ghost rows they read 7.5e-3 and 1.2e-2;
* float64, each route against the float64 oracle at 1e-10 (the routes
  against ``cfd_tpu`` at 1e-10: ``tests/test_torch_parallel.py``).
"""

import math

import numpy as np
import pytest
import torch

import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops.dense import dense_derivative
from cfd_tpu_torch.ops.rhs import closure_rows, compact_rhs
from cfd_tpu_torch.oracle import compact_rhs_np, derivative_np
from cfd_tpu_torch.parallel import DistributedCompactSolver, Grid, make_mesh

N = 64
DX = 2 * math.pi / N
ROUTES = ["pcr", "matmul", "phipsi", "kernel"]
F64_TOL = 1e-10


@pytest.fixture(scope="module")
def field():
    x = torch.arange(N, dtype=torch.float64) * DX
    f = torch.sin(x)[None, None, :] + torch.cos(x)[None, :, None] + torch.sin(2 * x)[:, None, None]
    return f.contiguous()


def _grid(scheme):
    return Grid(make_mesh((1, 1, 4), devices=["cpu"] * 4), (N, N, N), (DX, DX, DX), scheme)


def _rel(got, ref):
    return ((torch.as_tensor(got).double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ["SCHEME4_D2", "SCHEME6_D2"])
def test_float32_routes_within_twice_the_single_device_solve(field, name, route):
    scheme = getattr(tsch, name)
    exact = dense_derivative(field, DX, scheme, -1)
    single = _rel(dense_derivative(field.float(), DX, scheme, -1), exact)
    grid = _grid(scheme)
    solver = DistributedCompactSolver(grid, method=route)
    fs = grid.distribute(field.float())
    assert solver.route(fs, 2) == route
    got = grid.gather(solver.dfdx(fs))
    assert got.dtype == np.float32
    assert _rel(got, exact) <= 2 * single


@pytest.mark.parametrize("route", ROUTES[:3])
@pytest.mark.parametrize("name", ["SCHEME4_D2", "SCHEME6_D2", "SCHEME4"])
def test_float64_routes_match_the_oracle(field, name, route):
    scheme = getattr(tsch, name)
    exact = torch.from_numpy(derivative_np(scheme, field.numpy(), DX, axis=2))
    grid = _grid(scheme)
    got = grid.gather(DistributedCompactSolver(grid, method=route).dfdx(grid.distribute(field)))
    assert _rel(got, exact) <= F64_TOL


@pytest.mark.parametrize("name", ["SCHEME4", "SCHEME6", "SCHEME4_D2", "SCHEME6_D2"])
def test_difference_form_rows_equal_the_raw_rows_in_float64(name):
    """The closure rows and the whole-line RHS in difference form are the
    scheme's rows: equal to the raw sums in float64."""
    scheme = getattr(tsch, name)
    f = torch.from_numpy(np.random.default_rng(71).standard_normal((24, 3)))
    left, right = closure_rows(f, scheme)
    for j, row in enumerate(scheme.left_rows):
        raw = sum(c * f[m] for m, c in enumerate(row.rhs_stencil))
        assert torch.allclose(left[j], raw, rtol=0, atol=1e-12)
    for j, row in enumerate(scheme.right_rows):
        raw = sum(c * f[23 - m] for m, c in enumerate(row.rhs_stencil))
        assert torch.allclose(right[j], raw, rtol=0, atol=1e-12)
    want = compact_rhs_np(scheme, f.numpy(), 0.1)
    assert np.abs(compact_rhs(f, 0.1, scheme).numpy() - want).max() <= 1e-10 * np.abs(want).max()
