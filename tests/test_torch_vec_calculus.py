"""gradient, curl and laplacian, and the plain versions of their kernels
(K7 gradient_pair, K8 d2_pair_sum, K9 lap_rhs, K10 curl_rhs), against cfd_tpu.

Inputs are made by numpy from a seed and handed to both packages. On the
CPU the port's wrappers run their plain versions (dense operators), so:

* float32: each plain version against the Pallas kernel it replaces, in
  interpret mode, at the shapes the JAX package's own tests use
  (``tests/test_pair.py``; ``tests/test_lap.py``'s and ``tests/test_vec.py``'s
  12-plane ring-wrap cases, on 128^2 rather than 256^2, which only
  multiplies the interpret time; the z solves that finish K9 and K10
  against the float64 oracle, since the Pallas solve needs 64 planes):
  2e-5 * max|ref| for first derivatives and periodic
  second derivatives (the f32 recurrence gate), 5e-5 for second
  derivatives with closure rows (ROADMAP.md §C);
* float64: ``gradient``, ``curl`` and ``laplacian`` against ``cfd_tpu``'s,
  periodic and not, on the generic route and on the fused routes' plain
  versions, 1e-10 relative: the same operators in another order.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu
import cfd_tpu.schemes as jsch
from cfd_tpu.ops.pallas_lap import lap_rhs as pallas_lap_rhs
from cfd_tpu.oracle import derivative_np
from cfd_tpu.ops.pallas_leading import leading_derivative
from cfd_tpu.ops.pallas_pair import d2_pair_sum as pallas_d2_pair_sum
from cfd_tpu.ops.pallas_pair import gradient_pair as pallas_gradient_pair
from cfd_tpu.ops.pallas_vec import curl_rhs as pallas_curl_rhs

import cfd_tpu_torch as ct
import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops import adv_lap, lane, pair, strided, vec

F32_GATE = 2e-5
D2_WALL_GATE = 5e-5
F64_TOL = 1e-10
D1 = ["SCHEME4", "SCHEME4_PERIODIC", "SCHEME6", "SCHEME6_PERIODIC"]
D1_PERIODIC = ["SCHEME4_PERIODIC", "SCHEME6_PERIODIC"]
D2 = ["SCHEME4_D2", "SCHEME4_D2_PERIODIC", "SCHEME6_D2", "SCHEME6_D2_PERIODIC"]
D2_PERIODIC = ["SCHEME4_D2_PERIODIC", "SCHEME6_D2_PERIODIC"]


def _both(name):
    return getattr(jsch, name), getattr(tsch, name)


def _gate(scheme):
    return D2_WALL_GATE if scheme.derivative_order == 2 and not scheme.periodic else F32_GATE


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _fields(seed, shape, count, dtype=np.float32, offset=0.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) + offset).astype(dtype) for _ in range(count)]


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ---------------------------------------------------------------------------
# float32: plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", D1)
def test_gradient_pair_ref_matches_pallas_interpret(name):
    js, ts = _both(name)
    (f,) = _fields(70, (3, 256, 256), 1, offset=0.5)  # tests/test_pair.py's shape
    ref = pallas_gradient_pair(jnp.asarray(f), 0.03, 0.02, js, interpret=True)
    got = pair.gradient_pair(torch.from_numpy(f), 0.03, 0.02, ts)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), r) <= F32_GATE


@pytest.mark.parametrize("name", D2)
def test_d2_pair_sum_ref_matches_pallas_interpret(name):
    js, ts = _both(name)
    (f,) = _fields(71, (2, 256, 256), 1, offset=0.5)
    ref = pallas_d2_pair_sum(jnp.asarray(f), 0.03, 0.02, js, interpret=True)
    got = pair.d2_pair_sum(torch.from_numpy(f), 0.03, 0.02, ts)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= _gate(ts)


@pytest.mark.parametrize("name", ["SCHEME4_D2", "SCHEME6_D2"])
def test_walls_laplacian_route_ref_matches_pallas_interpret(name):
    """The non-periodic Laplacian's route: d2_pair_sum, then z with K2's
    ``acc`` epilogue on d2 closure rows (the JAX package's
    ``leading_derivative(f, dz, acc=s)``)."""
    js, ts = _both(name)
    (f,) = _fields(72, (64, 128, 128), 1, offset=0.5)
    dz, dy, dx = 0.04, 0.03, 0.02
    s_ref = pallas_d2_pair_sum(jnp.asarray(f), dy, dx, js, interpret=True)
    ref = leading_derivative(jnp.asarray(f), dz, js, acc=s_ref, interpret=True)
    s = pair.d2_pair_sum(torch.from_numpy(f), dy, dx, ts)
    got = strided.strided_derivative(torch.from_numpy(f), dz, ts, 0, acc=s)
    assert _rel(got.numpy(), ref) <= D2_WALL_GATE


@pytest.mark.parametrize("name", D2_PERIODIC)
def test_lap_rhs_and_solve_ref_match_pallas_interpret(name):
    """K9's plain version against ``_lap_rhs_kernel`` at
    ``tests/test_lap.py``'s 12-plane ring-wrap shape, and with K2's solve
    against the float64 oracle (the Pallas solve needs 64 planes)."""
    js, ts = _both(name)
    (f,) = _fields(73, (12, 128, 128), 1, offset=0.5)
    dz, dy, dx = 0.04, 0.03, 0.02
    ref_r = pallas_lap_rhs(jnp.asarray(f), dz, dy, dx, js, interpret=True)
    r = adv_lap.lap_rhs(torch.from_numpy(f), dz, dy, dx, ts)
    assert r.dtype == torch.float32
    assert _rel(r.numpy(), ref_r) <= F32_GATE
    f64 = f.astype(np.float64)
    ref = sum(derivative_np(js, f64, d, axis=a) for a, d in ((-1, dx), (-2, dy), (-3, dz)))
    assert _rel(strided.leading_solve(r, ts).numpy(), ref) <= F32_GATE


@pytest.mark.parametrize("name", D1_PERIODIC)
def test_curl_rhs_and_fused_ref_match_pallas_interpret(name):
    """K10's plain version against ``_curl_kernel`` at ``tests/test_vec.py``'s
    12-plane ring-wrap shape, and the fused curl against the float64 oracle."""
    js, ts = _both(name)
    u = _fields(74, (12, 128, 128), 3, offset=0.3)
    dz, dy, dx = 0.04, 0.03, 0.02
    ref_rhs = pallas_curl_rhs(*(jnp.asarray(c) for c in u), dz, dy, dx, js, interpret=True)
    got_rhs = vec.curl_rhs(*_t(*u), dz, dy, dx, ts)
    for g, r in zip(got_rhs, ref_rhs):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), r) <= F32_GATE
    ux, uy, uz = (c.astype(np.float64) for c in u)
    d = lambda c, h, a: derivative_np(js, c, h, axis=a)
    ref = (d(uz, dy, -2) - d(uy, dz, -3), d(ux, dz, -3) - d(uz, dx, -1),
           d(uy, dx, -1) - d(ux, dy, -2))
    for g, r in zip(vec.curl_fused(_t(*u), dz, dy, dx, ts), ref):
        assert _rel(g.numpy(), r) <= F32_GATE


# ---------------------------------------------------------------------------
# float64: the composites against cfd_tpu
# ---------------------------------------------------------------------------

SHAPE = (16, 12, 20)
LENGTHS = (2 * math.pi, 2 * math.pi, 4.0)
SPACING = tuple(L / n for n, L in zip(SHAPE, LENGTHS))


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
    assert np.abs(got.numpy() - ref).max() <= F64_TOL * np.abs(ref).max()


@pytest.mark.parametrize("name", D1)
def test_gradient_and_curl_float64_match_cfd_tpu(name):
    js, ts = _both(name)
    u = _fields(75, SHAPE, 3, np.float64)
    for g, r in zip(ct.gradient(torch.from_numpy(u[0]), SPACING, ts),
                    cfd_tpu.gradient(jnp.asarray(u[0]), SPACING, js)):
        _close(g, r)
    # the pair kernel's plain version is the x and y of the same gradient
    for g, r in zip(pair.gradient_pair(torch.from_numpy(u[0]), SPACING[1], SPACING[2], ts),
                    cfd_tpu.gradient(jnp.asarray(u[0]), SPACING, js)[:2]):
        _close(g, r)
    ref = cfd_tpu.curl(tuple(jnp.asarray(c) for c in u), SPACING, js)
    for g, r in zip(ct.curl(_t(*u), SPACING, ts), ref):
        _close(g, r)
    if ts.periodic:  # the fused route's plain version: K10, then two z solves
        for g, r in zip(vec.curl_fused(_t(*u), *SPACING, ts), ref):
            _close(g, r)


@pytest.mark.parametrize("name", D2)
def test_laplacian_float64_matches_cfd_tpu_on_every_route(name):
    js, ts = _both(name)
    (f,) = _fields(76, SHAPE, 1, np.float64)
    ref = cfd_tpu.laplacian(jnp.asarray(f), SPACING, js)
    t = torch.from_numpy(f)
    dz, dy, dx = SPACING
    _close(ct.laplacian(t, SPACING, ts), ref)  # the sum of three d2 calls
    # K8 + K2 acc (the non-periodic route), K8 + d2fdz2 (fields of 4 axes)
    s = pair.d2_pair_sum(t, dy, dx, ts)
    _close(strided.strided_derivative(t, dz, ts, 0, acc=s), ref)
    _close(s + ct.d2fdz2(t, dz, ts), ref)
    if ts.periodic:  # K9 + K2's solve
        _close(strided.leading_solve(adv_lap.lap_rhs(t, dz, dy, dx, ts), ts), ref)


# ---------------------------------------------------------------------------
# routing and refusals
# ---------------------------------------------------------------------------


def test_supported_predicates_follow_the_jax_routes():
    f32, f64 = torch.float32, torch.float64
    assert pair.pair_supported(tsch.SCHEME4, 256, 256, f32)
    assert pair.pair_supported(tsch.SCHEME6_PERIODIC, 96, 200, f32)
    assert not pair.pair_supported(tsch.SCHEME4_D2, 256, 256, f32)
    assert not pair.pair_supported(tsch.SCHEME4, 256, 256, f64)
    assert not pair.pair_supported(tsch.SCHEME4, 8, 20000, f32)  # x-line past 48 KB
    assert pair.pair_supported(tsch.SCHEME6, 6, 6, f32)  # lele6's min_points: 6
    assert not pair.pair_supported(tsch.SCHEME6, 5, 9, f32)
    assert not pair.pair_supported(tsch.SCHEME6, 9, 5, f32)
    assert not pair.d2_sum_supported(tsch.SCHEME6_D2, 5, 256, f32)
    assert not vec.curl_fused_supported(tsch.SCHEME6_PERIODIC, 40, 4, 200, f32)
    assert pair.d2_sum_supported(tsch.SCHEME6_D2, 256, 256, f32)
    assert not pair.d2_sum_supported(tsch.SCHEME4, 256, 256, f32)
    assert adv_lap.lap_rhs_supported(tsch.SCHEME4_D2_PERIODIC, 256, 256, 256, f32)
    assert not adv_lap.lap_rhs_supported(tsch.SCHEME4_D2, 256, 256, 256, f32)
    assert not adv_lap.lap_rhs_supported(tsch.SCHEME6_D2_PERIODIC, 4, 256, 256, f32)
    assert vec.curl_fused_supported(tsch.SCHEME4_PERIODIC, 40, 96, 200, f32)
    assert not vec.curl_fused_supported(tsch.SCHEME4, 40, 96, 200, f32)
    assert not vec.curl_fused_supported(tsch.SCHEME4_PERIODIC, 40, 96, 200, f64)


def test_vector_calculus_on_cpu_launches_nothing():
    counters = (lane, strided, pair, adv_lap, vec)
    names = ("LAUNCHES", "GRADIENT_LAUNCHES", "D2_SUM_LAUNCHES", "LAP_LAUNCHES",
             "CURL_LAUNCHES")

    def counts():
        return [getattr(m, n) for m in counters for n in names if hasattr(m, n)]

    before = counts()
    u = _t(*_fields(78, SHAPE, 3))
    ct.gradient(u[0], SPACING, tsch.SCHEME4_PERIODIC)
    ct.curl(u, SPACING, tsch.SCHEME4_PERIODIC)
    ct.laplacian(u[0], SPACING, tsch.SCHEME4_D2_PERIODIC)
    ct.laplacian(u[0], SPACING, tsch.SCHEME4_D2)
    assert counts() == before


def test_kernels_refuse_what_they_do_not_take():
    f = torch.zeros(8, 16, 32)
    with pytest.raises(ValueError, match="first-derivative"):
        pair.gradient_pair(f, 0.1, 0.1, tsch.SCHEME4_D2)
    with pytest.raises(ValueError, match="second-derivative"):
        pair.d2_pair_sum(f, 0.1, 0.1, tsch.SCHEME4)
    with pytest.raises(ValueError, match="periodic d2"):
        adv_lap.lap_rhs(f, 0.1, 0.1, 0.1, tsch.SCHEME4_D2)
    with pytest.raises(ValueError, match="periodic d1"):
        vec.curl_rhs(f, f, f, 0.1, 0.1, 0.1, tsch.SCHEME4)
    with pytest.raises(ValueError, match="three equal-shape"):
        vec.curl_rhs(f, f, f[:4], 0.1, 0.1, 0.1, tsch.SCHEME4_PERIODIC)
    with pytest.raises(ValueError, match="derivative_order=2"):
        ct.laplacian(f, 0.1, tsch.SCHEME4)
