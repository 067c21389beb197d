"""The stepwise fused RK3 substep (K13 ``advection_pair``, K9, K2's ``mul`` +
``acc`` and ``rk`` modes) and its routes in the three models, against
cfd_tpu; and the shell sum of the energy spectrum.

Inputs are made by numpy from a seed and handed to both packages. On the
CPU the port's wrappers run their plain versions (dense operators), so:

* float32: ``advection_pair_ref`` against cfd_tpu's ``advection_pair``
  (``_adv_pair_kernel`` in interpret mode) at 1e-5 * max|ref| (the
  recurrence gate); ``rk3_solve_update_ref`` against cfd_tpu's
  ``rk3_solve_update`` (``_leading_kernel(rk=True)`` in interpret mode) at
  5e-5 (the d2 gate of ``tests/test_torch_fused.py``), at nu = 1e-2 and at
  dt * nu = 1, where the solve is O(1) of the update; the stepwise substep
  against cfd_tpu's fused substep at 1e-3 of the increment
  (``tests/test_models.py``'s gate);
* float64: the four (head, tail) routes of the substep against each other
  at 1e-10; three steps of each model on the stepwise head, and with no
  head at all (the generic form), against cfd_tpu's generic model at 1e-10.

The routes are forced by monkeypatching the fit predicates: the x-lines
that select them (nx >= 6135) are too long for the dense operators of a CPU
test. The predicates themselves are held at their edges.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu.models as jm
import cfd_tpu.schemes as jsch
from cfd_tpu.ops.fused_step import make_fused_substep as jax_fused_substep
from cfd_tpu.ops.pallas_leading import rk3_solve_update as pallas_rk3_solve_update
from cfd_tpu.ops.pallas_pair import advection_pair as pallas_advection_pair

import cfd_tpu_torch as ct
import cfd_tpu_torch.models as tm
import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops import _native, adv_lap, fused_step, lane, megastep, pair, spectra, strided
from cfd_tpu_torch.ops.fused_step import make_fused_substep, make_fused_substep_vec

GATE = 1e-5
D2_GATE = 5e-5
STEP_GATE = 1e-3
F64_TOL = 1e-10
CPU = torch.device("cpu")
D1_SCHEMES = ["SCHEME4", "SCHEME4_PERIODIC", "SCHEME6", "SCHEME6_PERIODIC"]
D2_SCHEMES = ["SCHEME4_D2", "SCHEME4_D2_PERIODIC", "SCHEME6_D2", "SCHEME6_D2_PERIODIC"]
RK3 = {  # (a, b, has q) of the Williamson substeps
    "first": (0.0, 1.0 / 3.0, False),
    "middle": (-5.0 / 9.0, 15.0 / 16.0, True),
    "last": (-153.0 / 128.0, 8.0 / 15.0, True),
}
SHAPE = (16, 12, 20)
LENGTHS = (2 * math.pi, 2 * math.pi, 4.0)
SPACING = tuple(L / n for n, L in zip(SHAPE, LENGTHS))


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


@pytest.fixture
def no_merged_head(monkeypatch):
    """x-lines that K3 and K5 do not take (nx >= 6135): the stepwise head."""
    monkeypatch.setattr(adv_lap, "adv_lap_fits", lambda shape: False)
    monkeypatch.setattr(adv_lap, "adv_lap3_fits", lambda shape: False)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels they replace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", D1_SCHEMES)
def test_advection_pair_ref_matches_pallas_interpret(name):
    js, ts = _both(name)
    f, ux, uy = _fields(61, (2, 128, 128), 3)
    dy, dx = 0.05, 0.04
    ref = pallas_advection_pair(*(jnp.asarray(a) for a in (f, ux, uy)), dy, dx, js,
                                interpret=True)
    got = pair.advection_pair_ref(*_t(f, ux, uy), dy, dx, ts)
    assert got.dtype == torch.float32 and got.shape == f.shape
    assert _rel(got.numpy(), ref) <= GATE


@pytest.mark.parametrize("nu", [1e-2, 1e3], ids=["nu1e-2", "dt_nu1"])
@pytest.mark.parametrize("case", list(RK3))
@pytest.mark.parametrize("name", D2_SCHEMES)
def test_rk3_solve_update_ref_matches_pallas_interpret(name, case, nu):
    js, ts = _both(name)
    a, b, has_q = RK3[case]
    r, adv, fin, q = _fields(62, (64, 8, 128), 4)
    q = q if has_q else None
    kw = dict(a=a, b=b, dt=1e-3, nu=nu)
    ref_q, ref_f = pallas_rk3_solve_update(
        *(jnp.asarray(x) for x in (r, adv)), None if q is None else jnp.asarray(q),
        jnp.asarray(fin), js, interpret=True, **kw)
    got_q, got_f = strided.rk3_solve_update_ref(
        *_t(r, adv), None if q is None else torch.from_numpy(q), torch.from_numpy(fin), ts, **kw)
    assert got_q.dtype == got_f.dtype == torch.float32
    assert _rel(got_q.numpy(), ref_q) <= D2_GATE
    assert _rel(got_f.numpy(), ref_f) <= D2_GATE


def test_rk3_solve_update_cpu_is_its_plain_version_and_checks_shapes():
    s = tsch.SCHEME4_D2_PERIODIC
    r, adv, fin, q = _t(*_fields(63, (16, 4, 8), 4))
    before = dict(strided.MODE_LAUNCHES)
    got = ct.ops.rk3_solve_update(r, adv, q, fin, s, a=-0.5, b=0.9, dt=1e-3, nu=1.0)
    want = strided.rk3_solve_update_ref(r, adv, q, fin, s, a=-0.5, b=0.9, dt=1e-3, nu=1.0)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert strided.MODE_LAUNCHES == before
    with pytest.raises(ValueError, match="shape"):
        strided.rk3_solve_update(r, adv[:4], None, fin, s, a=0.0, b=1.0, dt=1e-3, nu=1.0)
    with pytest.raises(ValueError, match="second-derivative"):
        strided.rk3_solve_update(r, adv, None, fin, tsch.SCHEME4, a=0.0, b=1.0, dt=1e-3, nu=1.0)
    with pytest.raises(ValueError, match="velocity shapes"):
        pair.advection_pair(r, adv[:4], fin, 0.1, 0.1, tsch.SCHEME4)


# ---------------------------------------------------------------------------
# Predicates: where each head and tail is taken
# ---------------------------------------------------------------------------


def test_fit_predicates_at_their_edges():
    s = tsch.SCHEME4_PERIODIC
    assert adv_lap.adv_lap_fits((8, 8, 6134)) and not adv_lap.adv_lap_fits((8, 8, 6135))
    assert adv_lap.adv_lap3_fits((8, 8, 6134)) and not adv_lap.adv_lap3_fits((8, 8, 6135))
    assert _native.xy_planes_fit(s, 8, 12278) and not _native.xy_planes_fit(s, 8, 12279)
    assert pair.adv_pair_supported(s, 8, 12278, torch.float32)
    assert not pair.adv_pair_supported(s, 8, 12279, torch.float32)
    assert not pair.adv_pair_supported(s, 8, 128, torch.float64)
    assert megastep.rk3_mega_supported(s, tsch.SCHEME4_D2_PERIODIC, (64, 128, 8192), torch.float32)
    assert not megastep.rk3_mega_supported(s, tsch.SCHEME4_D2_PERIODIC, (64, 8, 8), torch.float64)


def test_routes_by_shape_dtype_and_device():
    s1, s2 = tsch.SCHEME4_PERIODIC, tsch.SCHEME4_D2_PERIODIC
    meta = lambda shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    assert fused_step.head_route(meta((8, 8, 6134)), s1, s2) is fused_step.merged_head
    assert fused_step.head_route(meta((64, 128, 8192)), s1, s2) is fused_step.stepwise_head
    assert fused_step.head_route(meta((8, 8, 12278)), s1, s2) is fused_step.stepwise_head
    assert fused_step.head_route(meta((8, 8, 12279)), s1, s2) is None
    assert fused_step.head_route(meta((8, 8, 64), torch.float64), s1, s2) is None
    assert fused_step.tail_route(meta((64, 128, 8192)), s1, s2) is fused_step.mega_tail
    # a CPU tensor takes the route of a float32 field of its shape on the card
    cpu64 = torch.zeros((8, 8, 16), dtype=torch.float64)
    assert fused_step.head_route(cpu64, s1, s2) is fused_step.merged_head
    assert fused_step.tail_route(cpu64, s1, s2) is fused_step.mega_tail


# ---------------------------------------------------------------------------
# The substep's routes
# ---------------------------------------------------------------------------

ROUTES = {  # (head, tail) forced: merged/stepwise x mega/stepwise
    "merged+mega": (False, False),
    "stepwise+mega": (True, False),
    "merged+stepwise": (False, True),
    "stepwise+stepwise": (True, True),
}


def _force(monkeypatch, stepwise_head, stepwise_tail):
    if stepwise_head:
        monkeypatch.setattr(adv_lap, "adv_lap_fits", lambda shape: False)
    if stepwise_tail:
        monkeypatch.setattr(megastep, "rk3_mega_supported", lambda *args: False)


@pytest.mark.parametrize("route", list(ROUTES))
def test_substep_routes_agree_in_float64(monkeypatch, route):
    """Each (head, tail) route against the merged K3 + K4 substep on the
    same float64 inputs, first, middle and last substep: the same operators
    in another order."""
    s1, s2 = tsch.SCHEME6_PERIODIC, tsch.SCHEME6_D2_PERIODIC
    f, ux, uy, uz, q = _t(*_fields(64, SHAPE, 5, np.float64))
    merged = make_fused_substep(SPACING, s1, s2)
    want = {case: merged(f, (ux, uy, uz), q if RK3[case][2] else None, 1e-3, 1.0,
                         *RK3[case][:2], last=case == "last") for case in RK3}
    _force(monkeypatch, *ROUTES[route])
    head = fused_step.head_route(f, s1, s2)
    tail = fused_step.tail_route(f, s1, s2)
    assert (head is fused_step.stepwise_head) == ROUTES[route][0]
    assert (tail is fused_step.stepwise_tail) == ROUTES[route][1]
    substep = make_fused_substep(SPACING, s1, s2)
    for case, (a, b, has_q) in RK3.items():
        got_q, got_f = substep(f, (ux, uy, uz), q if has_q else None, 1e-3, 1.0, a, b,
                               last=case == "last")
        want_q, want_f = want[case]
        assert _rel(got_f.numpy(), want_f.numpy()) <= F64_TOL
        if case == "last":
            assert got_q is None and want_q is None
        else:
            assert _rel(got_q.numpy(), want_q.numpy()) <= F64_TOL


def test_stepwise_step_float32_matches_cfd_tpu_fused(monkeypatch):
    """One step on the stepwise head and tail in float32 against cfd_tpu's
    fused step (its kernels in interpret mode), at 1e-3 of the increment."""
    shape = (64, 128, 128)
    spacing = (2 * math.pi / 64, 2 * math.pi / 128, 2 * math.pi / 128)
    z, y, x = (np.arange(n) * d for n, d in zip(shape, spacing))
    u = [np.asarray(c) for c in jm.taylor_green(jnp.asarray(z), jnp.asarray(y), jnp.asarray(x))]
    f0 = (np.sin(x)[None, None, :] + 0.1 * np.random.default_rng(65).standard_normal(shape))
    j1, j2 = jsch.SCHEME4_PERIODIC, jsch.SCHEME4_D2_PERIODIC
    jderivs = jm.Derivs.single_device(spacing, j1, method="auto", second_derivative=True)
    jderivs = dataclasses.replace(
        jderivs, fused_substep=jax_fused_substep(spacing, j1, j2, interpret=True))
    fj = jm.AdvectionDiffusion(jderivs, nu=1e-2).step(
        jnp.asarray(f0, jnp.float32), tuple(jnp.asarray(c, jnp.float32) for c in u), 1e-3)
    _force(monkeypatch, True, True)
    f, ut = tm.state_from_numpy(f0, u, CPU, torch.float32)
    model = tm.AdvectionDiffusion(
        tm.Derivs.single_device(spacing, tsch.SCHEME4_PERIODIC, "auto", second_derivative=True),
        nu=1e-2)
    assert fused_step.head_route(f, tsch.SCHEME4_PERIODIC, tsch.SCHEME4_D2_PERIODIC) \
        is fused_step.stepwise_head
    ft = model.step(f, ut, 1e-3)
    assert ft.dtype == torch.float32
    fj = np.asarray(fj, np.float64)
    inc = np.abs(fj - np.float32(f0)).max()
    assert np.abs(ft.numpy() - fj).max() / inc < STEP_GATE


def test_stepwise_routes_on_cpu_launch_nothing(no_merged_head, monkeypatch):
    monkeypatch.setattr(megastep, "rk3_mega_supported", lambda *args: False)
    counters = (lane, strided, adv_lap, megastep, pair)
    before = [m.LAUNCHES for m in counters] + [pair.ADV_PAIR_LAUNCHES, adv_lap.LAP_LAUNCHES,
                                               dict(strided.MODE_LAUNCHES)]
    f, ux, uy, uz = _t(*_fields(66, SHAPE, 4))
    q, out = make_fused_substep(SPACING, tsch.SCHEME4_PERIODIC, tsch.SCHEME4_D2_PERIODIC)(
        f, (ux, uy, uz), None, 1e-3, 1e-2, 0.0, 1.0 / 3.0)
    assert out.dtype == q.dtype == torch.float32 and torch.isfinite(out).all()
    after = [m.LAUNCHES for m in counters] + [pair.ADV_PAIR_LAUNCHES, adv_lap.LAP_LAUNCHES,
                                              dict(strided.MODE_LAUNCHES)]
    assert after == before


# ---------------------------------------------------------------------------
# The models on the stepwise head, and with no head, against cfd_tpu
# ---------------------------------------------------------------------------


def _velocity(seed=67):
    """Taylor–Green plus a seeded smooth perturbation with uz != 0."""
    z, y, x = (np.arange(n) * (L / n) for n, L in zip(SHAPE, LENGTHS))
    u = [np.asarray(c) for c in jm.taylor_green(jnp.asarray(z), jnp.asarray(y), jnp.asarray(x))]
    rng = np.random.default_rng(seed)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    for c in range(3):
        a, b = rng.uniform(-0.2, 0.2, 2)
        u[c] = u[c] + a * np.sin(Z + b) * np.cos(2 * math.pi * X / LENGTHS[2]) + b * np.cos(Y)
    return u


def _jax_steps(model, u, steps=3):
    u = tuple(jnp.asarray(c) for c in u)
    for _ in range(steps):
        u = model.step(u, 1e-3)
    return [np.asarray(c) for c in u]


def _scalar_case(name, steps=3):
    js, ts = _both(name)
    u = _velocity()
    f0 = np.sin(2 * math.pi * np.arange(SHAPE[2]) / SHAPE[2])[None, None, :] + 0.3 * u[0]
    jmodel = jm.AdvectionDiffusion(
        jm.Derivs.single_device(SPACING, js, "auto", second_derivative=True), nu=1e-2)
    fj = jnp.asarray(f0)
    for _ in range(steps):
        fj = jmodel.step(fj, tuple(jnp.asarray(c) for c in u), 1e-3)
    derivs = tm.Derivs.single_device(SPACING, ts, "auto", second_derivative=True)
    f, ut = tm.state_from_numpy(f0, u, CPU, torch.float64)
    return derivs, f, ut, np.asarray(fj)


@pytest.mark.parametrize("head", ["stepwise", "none"])
@pytest.mark.parametrize("name", ["SCHEME4_PERIODIC", "SCHEME6_PERIODIC"])
def test_advection_diffusion_float64_matches_cfd_tpu_generic(monkeypatch, head, name):
    derivs, f, u, ref = _scalar_case(name)
    ts = getattr(tsch, name)
    d2 = tsch.get_scheme(ts.order, True, derivative=2)
    if head == "stepwise":
        _force(monkeypatch, True, False)
        assert fused_step.head_route(f, ts, d2) is fused_step.stepwise_head
    else:
        monkeypatch.setattr(_native, "x_lines_fit", lambda nx, tiles=1: False)
        assert derivs.fused_substep(f, u, None, 1e-3, 1e-2, 0.0, 1.0 / 3.0) is None
    got = tm.AdvectionDiffusion(derivs, nu=1e-2).run(f, u, 1e-3, 3)
    assert got.dtype == torch.float64 and torch.isfinite(got).all()
    assert np.abs(got.numpy() - ref).max() <= F64_TOL * np.abs(ref).max()


@pytest.mark.parametrize("head", ["stepwise", "none"])
@pytest.mark.parametrize("model", ["burgers", "ns"])
def test_velocity_models_float64_match_cfd_tpu_generic(monkeypatch, head, model):
    """Burgers and Navier–Stokes where K5 does not fit (the scalar substep
    on the stepwise head per component) and where no head fits (the generic
    stage), three steps against cfd_tpu's generic model."""
    js, ts = _both("SCHEME4_PERIODIC")
    if model == "ns":
        jmodel = jm.NavierStokes.single_device(SPACING, js, nu=1e-2)
        u = [np.asarray(c) for c in jmodel.project(tuple(jnp.asarray(c) for c in _velocity()))]
        tmodel = tm.NavierStokes.single_device(SPACING, ts, nu=1e-2)
    else:
        jmodel = jm.Burgers(jm.Derivs.single_device(SPACING, js, "auto", second_derivative=True),
                            nu=1e-2)
        u = _velocity()
        tmodel = tm.Burgers(tm.Derivs.single_device(SPACING, ts, "auto", second_derivative=True),
                            nu=1e-2)
    ref = _jax_steps(jmodel, u)
    if head == "stepwise":
        monkeypatch.setattr(adv_lap, "adv_lap_fits", lambda shape: False)
        monkeypatch.setattr(adv_lap, "adv_lap3_fits", lambda shape: False)
    else:
        monkeypatch.setattr(_native, "x_lines_fit", lambda nx, tiles=1: False)
    ut = tm.tensors_from_numpy(u, CPU, torch.float64)
    assert tmodel.derivs.fused_substep_vec(ut, None, 1e-3, 1e-2, 0.0, 1.0 / 3.0) is None
    stepwise = tmodel.derivs.fused_substep(ut[0], ut, None, 1e-3, 1e-2, 0.0, 1.0 / 3.0)
    assert (stepwise is None) == (head == "none")
    got = tmodel.run(ut, 1e-3, 3)
    scale = max(np.abs(c).max() for c in ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        assert np.abs(g.numpy() - r).max() <= F64_TOL * scale


def test_vec_substep_declines_where_k5_does_not_fit(no_merged_head):
    s1, s2 = tsch.SCHEME4_PERIODIC, tsch.SCHEME4_D2_PERIODIC
    u = _t(*_fields(68, SHAPE, 3))
    assert make_fused_substep_vec(SPACING, s1, s2)(u, None, 1e-3, 1e-2, 0.0, 1 / 3) is None
    assert make_fused_substep(SPACING, s1, s2)(u[0], u, None, 1e-3, 1e-2, 0.0, 1 / 3) is not None


# ---------------------------------------------------------------------------
# The energy spectrum's shell sum (a fixed order: no atomics)
# ---------------------------------------------------------------------------


def test_energy_spectrum_is_bitwise_reproducible_and_exact():
    shape = (12, 16, 20)
    spacing = (0.3, 0.2, 0.25)
    u = _t(*_fields(69, shape, 3))
    first = spectra.energy_spectrum(u, spacing)
    second = spectra.energy_spectrum(u, spacing)
    assert torch.equal(first, second)
    # against a float64 bincount of the same modes
    bins, weights, _ = spectra._shell_tables(shape, spacing)
    power = sum(np.abs(np.fft.rfftn(c.numpy().astype(np.float64))) ** 2 for c in u) * weights
    want = 0.5 * np.bincount(bins.ravel(), power.ravel()) / float(np.prod(shape)) ** 2
    assert np.abs(first.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    u64 = tuple(c.double() for c in u)
    got64 = spectra.energy_spectrum(u64, spacing).numpy()
    assert np.abs(got64 - want).max() <= 1e-13 * np.abs(want).max()

