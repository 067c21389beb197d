"""Burgers, Navier–Stokes and their kernels' plain versions against cfd_tpu.

Inputs are made by numpy from a seed and handed to both packages. On the
CPU the port's wrappers run their plain versions (dense operators), so:

* float32: the plain K5 (``adv_lap_rhs3``), K6 + K2's solve (the fused
  divergence), ``pair_subtract`` and K2's ``acc``/``mul`` epilogues against
  the Pallas kernels they replace, in interpret mode at the shapes the JAX
  package's own tests use, 5e-5 * max|ref| (the gate of
  ``tests/test_torch_fused.py``);
* float64: ``solve_poisson``, both ``project`` forms and 2 steps each of
  ``Burgers`` and ``NavierStokes`` against ``cfd_tpu``'s, 1e-10 relative:
  the same operators in another order, so only rounding separates them.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu.models as jm
import cfd_tpu.ops.poisson as jpoisson
import cfd_tpu.schemes as jsch
from cfd_tpu.ops.pallas_lap import adv_lap_rhs3 as pallas_adv_lap3
from cfd_tpu.ops.pallas_leading import leading_derivative, leading_solve
from cfd_tpu.ops.pallas_pair import pair_subtract as pallas_pair_subtract
from cfd_tpu.ops.pallas_vec import div_rhs as pallas_div_rhs

import cfd_tpu_torch as ct
import cfd_tpu_torch.models as tm
import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops import adv_lap, lane, megastep, pair, poisson, strided, vec
from cfd_tpu_torch.ops.fused_step import make_fused_substep, make_fused_substep_vec

F32_GATE = 5e-5
F64_TOL = 1e-10
CPU = torch.device("cpu")
D1_PERIODIC = ["SCHEME4_PERIODIC", "SCHEME6_PERIODIC"]


def _both(name):
    return getattr(jsch, name), getattr(tsch, name)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _fields(seed, shape, count, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(count)]


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ---------------------------------------------------------------------------
# float32: plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def test_adv_lap_rhs3_ref_matches_pallas_interpret():
    (j1, t1), (j2, t2) = _both("SCHEME4_PERIODIC"), _both("SCHEME4_D2_PERIODIC")
    u = _fields(41, (8, 256, 256), 3)  # tests/test_fused3.py's shape
    ref_axy, ref_r = pallas_adv_lap3(tuple(jnp.asarray(c) for c in u), 0.1, 0.09, 0.08,
                                     j1, j2, interpret=True)
    axy, r = adv_lap.adv_lap_rhs3(_t(*u), 0.1, 0.09, 0.08, t1, t2)
    for i in range(3):
        assert axy[i].dtype == r[i].dtype == torch.float32
        assert _rel(axy[i].numpy(), ref_axy[i]) <= F32_GATE
        assert _rel(r[i].numpy(), ref_r[i]) <= F32_GATE


@pytest.mark.parametrize("name", D1_PERIODIC)
def test_fused_divergence_ref_matches_pallas_interpret(name):
    js, ts = _both(name)
    u = _fields(42, (64, 128, 128), 3)
    dz, dy, dx = 0.04, 0.03, 0.02
    ref_r = pallas_div_rhs(*(jnp.asarray(c) for c in u), dz, dy, dx, js, interpret=True)
    ref_div = leading_solve(ref_r, js, interpret=True)  # = divergence_fused
    r = vec.div_rhs(*_t(*u), dz, dy, dx, ts)
    assert _rel(r.numpy(), ref_r) <= F32_GATE
    div = vec.divergence_fused(_t(*u), dz, dy, dx, ts)
    assert div.dtype == torch.float32
    assert _rel(div.numpy(), ref_div) <= F32_GATE


@pytest.mark.parametrize("name", D1_PERIODIC)
def test_pair_subtract_ref_matches_pallas_interpret(name):
    js, ts = _both(name)
    f, ax, ay = _fields(43, (3, 256, 256), 3)  # tests/test_pair.py's shape
    ref = pallas_pair_subtract(*(jnp.asarray(a) for a in (f, ax, ay)), 0.03, 0.02, js,
                               interpret=True)
    got = pair.pair_subtract(*_t(f, ax, ay), 0.03, 0.02, ts)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), r) <= F32_GATE


@pytest.mark.parametrize("mode", ["acc", "mul", "solve"])
def test_leading_modes_ref_match_pallas_interpret(mode):
    """K2's epilogues: the projection's ``uz - dphi/dz`` (``acc`` with
    -dz, as poisson.py:591), ``mul * fz + acc``, and the bare solve."""
    js, ts = _both("SCHEME4_PERIODIC")
    phi, uz, m = _fields(44, (64, 16, 256), 3)  # tests/test_pair.py's shape
    dz = 0.04
    if mode == "solve":
        ref = leading_solve(jnp.asarray(phi), js, interpret=True)
        got = strided.leading_solve(torch.from_numpy(phi), ts)
    else:
        mul = m if mode == "mul" else None
        ref = leading_derivative(jnp.asarray(phi), -dz, js, acc=jnp.asarray(uz),
                                 mul=None if mul is None else jnp.asarray(mul), interpret=True)
        got = strided.strided_derivative(torch.from_numpy(phi), -dz, ts, 0,
                                         acc=torch.from_numpy(uz),
                                         mul=None if mul is None else torch.from_numpy(mul))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= F32_GATE


# ---------------------------------------------------------------------------
# float64: the spectral subsystem and the models against cfd_tpu
# ---------------------------------------------------------------------------

SHAPE = (16, 12, 20)
LENGTHS = (2 * math.pi, 2 * math.pi, 4.0)
SPACING = tuple(L / n for n, L in zip(SHAPE, LENGTHS))


def _velocity(seed=45, shape=SHAPE, lengths=LENGTHS):
    """Taylor–Green plus a seeded smooth perturbation with uz != 0."""
    z, y, x = (np.arange(n) * (L / n) for n, L in zip(shape, lengths))
    u = [np.asarray(c) for c in jm.taylor_green(jnp.asarray(z), jnp.asarray(y), jnp.asarray(x))]
    rng = np.random.default_rng(seed)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    for c in range(3):
        a, b, d = rng.uniform(-0.2, 0.2, 3)
        u[c] = u[c] + a * np.sin(Z + b) * np.cos(2 * np.pi * X / lengths[2] + d) + b * np.cos(Y)
    return u


@pytest.mark.parametrize("name", ["SCHEME4_PERIODIC", "SCHEME6_D2_PERIODIC"])
def test_solve_poisson_float64_matches_cfd_tpu(name):
    js, ts = _both(name)
    (rhs,) = _fields(46, SHAPE, 1, np.float64)
    rhs -= rhs.mean()
    ref = np.asarray(jpoisson.solve_poisson(jnp.asarray(rhs), SPACING, js, mean=0.5))
    got = poisson.solve_poisson(torch.from_numpy(rhs), SPACING, ts, mean=0.5)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - ref).max() <= F64_TOL * np.abs(ref).max()
    # the round trip through the compact Laplacian it inverts (d2: exact)
    if ts.derivative_order == 2:
        lap = ct.laplacian(got, SPACING, ts)
        assert np.abs(lap.numpy() - rhs).max() <= 1e-9 * np.abs(rhs).max()


@pytest.mark.parametrize("method", ["spectral", "compact"])
@pytest.mark.parametrize("name", D1_PERIODIC)
def test_project_float64_matches_cfd_tpu(name, method):
    js, ts = _both(name)
    u = _fields(47, SHAPE, 3, np.float64)
    ref = jpoisson.project(tuple(jnp.asarray(c) for c in u), SPACING, js, method=method)
    got = poisson.project(_t(*u), SPACING, ts, method=method)
    scale = max(np.abs(c).max() for c in u)
    for g, r in zip(got, ref):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= F64_TOL * scale
    div = ct.divergence(got, SPACING, ts)
    assert div.abs().max().item() <= 1e-10 * scale / min(SPACING)


def _jax_steps(model, u, steps=2):
    """``steps`` of a cfd_tpu model, step by step (its ``run`` traces a
    ``lax.scan``, which takes minutes to compile on the CPU)."""
    u = tuple(jnp.asarray(c) for c in u)
    for _ in range(steps):
        u = model.step(u, 1e-3)
    return [np.asarray(c) for c in u]


@pytest.mark.parametrize("name", ["SCHEME6_PERIODIC", "SCHEME4"])
def test_burgers_two_steps_float64_match_cfd_tpu(name):
    """Every route of the port's stage (fused vec, scalar fused, generic)
    against cfd_tpu's generic step; the non-periodic scheme has only the
    generic route."""
    jderivs = jm.Derivs.single_device(SPACING, getattr(jsch, name), "auto", second_derivative=True)
    u = _velocity()
    ref = _jax_steps(jm.Burgers(derivs=jderivs, nu=1e-2), u)
    ts = getattr(tsch, name)
    derivs = tm.Derivs.single_device(SPACING, ts, "auto", second_derivative=True)
    assert (derivs.fused_substep_vec is not None) == (derivs.fused_substep is not None) == ts.periodic
    routes = [derivs,
              dataclasses.replace(derivs, fused_substep_vec=None),
              dataclasses.replace(derivs, fused_substep_vec=None, fused_substep=None)]
    scale = max(np.abs(c).max() for c in ref)
    for d in routes if ts.periodic else routes[:1]:
        got = tm.Burgers(d, nu=1e-2).run(tm.tensors_from_numpy(u, CPU, torch.float64), 1e-3, 2)
        for g, r in zip(got, ref):
            assert np.abs(g.numpy() - r).max() <= F64_TOL * scale


@pytest.mark.parametrize("name", D1_PERIODIC)
def test_navier_stokes_two_steps_float64_match_cfd_tpu(name):
    js, ts = _both(name)
    jns = jm.NavierStokes.single_device(SPACING, js, nu=1e-2)
    u = [np.asarray(c) for c in jns.project(tuple(jnp.asarray(c) for c in _velocity()))]
    ref = _jax_steps(jns, u)
    ns = tm.NavierStokes.single_device(SPACING, ts, nu=1e-2)
    got = ns.run(tm.tensors_from_numpy(u, CPU, torch.float64), 1e-3, 2)
    scale = max(np.abs(c).max() for c in ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        assert np.abs(g.numpy() - r).max() <= F64_TOL * scale
    assert ns.divergence(got).abs().max().item() <= 1e-10 * scale / min(SPACING)
    jref = tuple(jnp.asarray(c) for c in ref)
    p_ref = np.asarray(jns.pressure(jref))
    assert np.abs(ns.pressure(got).numpy() - p_ref).max() <= 1e-8 * np.abs(p_ref).max()
    assert abs(ns.kinetic_energy(got).item() - float(jns.kinetic_energy(jref))) <= 1e-12


def test_vec_substep_equals_three_scalar_substeps():
    """The vector momentum stage is the scalar fused substep per component,
    advected by the stage-start velocity (tests/test_fused3.py)."""
    t1, t2 = tsch.SCHEME4_PERIODIC, tsch.SCHEME4_D2_PERIODIC
    fsv = make_fused_substep_vec(SPACING, t1, t2)
    fs = make_fused_substep(SPACING, t1, t2)
    u = _t(*_fields(48, SHAPE, 3))
    q = _t(*_fields(49, SHAPE, 3))
    for qq, a, b, last in ((None, 0.0, 1 / 3, False), (q, -153 / 128, 8 / 15, True)):
        qv, uv = fsv(u, qq, 1e-3, 1e-2, a, b, last=last)
        for i in range(3):
            qi, ui = fs(u[i], u, None if qq is None else qq[i], 1e-3, 1e-2, a, b, last=last)
            assert torch.equal(uv[i], ui)
            assert (qv is None and qi is None) if last else torch.equal(qv[i], qi)


def test_navier_stokes_on_cpu_launches_nothing():
    counters = (lane, strided, adv_lap, megastep, vec, pair)
    before = [m.LAUNCHES for m in counters] + [adv_lap.LAUNCHES3, dict(strided.MODE_LAUNCHES)]
    ns = tm.NavierStokes.single_device(SPACING)
    u = ns.project(tm.tensors_from_numpy(_velocity(), CPU, torch.float32))
    out = ns(u, 1e-3)
    assert all(c.dtype == torch.float32 and torch.isfinite(c).all() for c in out)
    ns.pressure(out)
    after = [m.LAUNCHES for m in counters] + [adv_lap.LAUNCHES3, dict(strided.MODE_LAUNCHES)]
    assert after == before


@pytest.mark.parametrize("name", ["SCHEME4", "SCHEME4_D2_PERIODIC", "SCHEME6_D2"])
def test_navier_stokes_rejects_non_periodic_and_d2_schemes(name):
    with pytest.raises(ValueError, match="periodic derivative_order=1"):
        tm.NavierStokes.single_device(SPACING, getattr(tsch, name))
    with pytest.raises(ValueError, match="periodic|derivative_order=1"):
        poisson.project(_t(*_fields(50, SHAPE, 3)), SPACING, getattr(tsch, name))


def test_fused_routes_reject_what_they_do_not_take():
    f = torch.zeros(8, 16, 16)
    assert make_fused_substep_vec(0.1, tsch.SCHEME4, tsch.SCHEME4_D2) is None
    with pytest.raises(ValueError, match="first-derivative"):
        make_fused_substep_vec(0.1, tsch.SCHEME4_D2_PERIODIC, tsch.SCHEME4_D2_PERIODIC)
    with pytest.raises(ValueError, match="periodic d1"):
        vec.div_rhs(f, f, f, 0.1, 0.1, 0.1, tsch.SCHEME4)
    with pytest.raises(ValueError, match="three components"):
        adv_lap.adv_lap_rhs3((f, f), 0.1, 0.1, 0.1, tsch.SCHEME4_PERIODIC,
                             tsch.SCHEME4_D2_PERIODIC)
    with pytest.raises(ValueError, match="first-derivative"):
        pair.pair_subtract(f, f, f, 0.1, 0.1, tsch.SCHEME4_D2_PERIODIC)
    with pytest.raises(ValueError, match="shape"):
        strided.strided_derivative(f, 0.1, tsch.SCHEME4, 0, acc=f[:4])


def test_taylor_green_2d_matches_cfd_tpu():
    z, y, x = (np.arange(n) * (L / n) for n, L in zip(SHAPE, LENGTHS))
    (ju, jv, jw), jp = jm.taylor_green_2d(*(jnp.asarray(c) for c in (z, y, x)), t=0.3, nu=0.1)
    (u, v, w), p = tm.taylor_green_2d(*(torch.from_numpy(c) for c in (z, y, x)), t=0.3, nu=0.1)
    for got, ref in ((u, ju), (v, jv), (w, jw), (p, jp)):
        assert got.shape == SHAPE
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-14
