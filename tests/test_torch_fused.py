"""The fused RK3 substep (K3 ``adv_lap_rhs`` + K4 ``rk3_mega``) against cfd_tpu.

Inputs are made by numpy from a seed and handed to both packages. On the
CPU the port's wrappers run their plain versions (dense operators), so:

* float32: the plain versions against the Pallas kernels they replace, run
  in interpret mode as ``tests/test_lap.py`` and ``tests/test_leading.py``
  run them — 5e-5 * max|ref| per output (the gate the JAX package's fold
  kernels meet on d2, ``tests/test_second_derivative.py``); one fused step
  against cfd_tpu's fused step, gate rel(increment) < 1e-3 as
  ``tests/test_models.py`` holds its fused step to the generic one;
* float64: 3 steps of the port's fused path against cfd_tpu's generic
  ``second_derivative=True`` model (PCR on the CPU) — 1e-10 relative to
  max|f|: the same operators in another order, so only rounding separates
  them. The non-periodic configuration has no fused substep and runs the
  generic path, at the same gate.
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
from cfd_tpu.ops.pallas_lap import adv_lap_rhs as pallas_adv_lap
from cfd_tpu.ops.pallas_megastep import rk3_mega as pallas_mega

import cfd_tpu_torch.models as tm
import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops import adv_lap, lane, megastep, strided
from cfd_tpu_torch.ops.fused_step import make_fused_substep

F32_GATE = 5e-5
STEP_GATE = 1e-3
F64_TOL = 1e-10
CPU = torch.device("cpu")
PAIRS = {
    "pade4": ("SCHEME4_PERIODIC", "SCHEME4_D2_PERIODIC"),
    "lele6": ("SCHEME6_PERIODIC", "SCHEME6_D2_PERIODIC"),
}


def _schemes(pair):
    n1, n2 = PAIRS[pair]
    return (getattr(jsch, n1), getattr(jsch, n2)), (getattr(tsch, n1), getattr(tsch, n2))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _fields(seed, shape, count):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("pair", list(PAIRS))
def test_adv_lap_rhs_ref_matches_pallas_interpret(pair):
    (j1, j2), (t1, t2) = _schemes(pair)
    f, ux, uy = _fields(31, (8, 128, 128), 3)
    dz, dy, dx = 0.1, 0.05, 0.04
    ref_axy, ref_r = pallas_adv_lap(
        jnp.asarray(f), jnp.asarray(ux), jnp.asarray(uy), dz, dy, dx, j1, j2, interpret=True
    )
    axy, r = adv_lap.adv_lap_rhs_ref(
        *(torch.from_numpy(a) for a in (f, ux, uy)), dz, dy, dx, t1, t2
    )
    assert axy.dtype == r.dtype == torch.float32
    assert _rel(axy.numpy(), ref_axy) <= F32_GATE
    assert _rel(r.numpy(), ref_r) <= F32_GATE


@pytest.mark.parametrize("case", ["first", "middle", "last"])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_rk3_mega_ref_matches_pallas_interpret(pair, case):
    _rk3_mega_case(pair, case, nu=1e-2)


@pytest.mark.parametrize("case", ["first", "middle", "last"])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_rk3_mega_ref_diffusion_matches_pallas_interpret(pair, case):
    """dt * nu = 1: the T2z^{-1} r term is O(1) of q' and f' (at nu = 1e-2
    it is ~1e-5 of them, under the gate)."""
    _rk3_mega_case(pair, case, nu=1e3)


def _rk3_mega_case(pair, case, nu):
    (j1, j2), (t1, t2) = _schemes(pair)
    f, r, axy, uz, q = _fields(32, (64, 16, 128), 5)
    q = None if case == "first" else q
    write_q = case != "last"
    kw = dict(a=-5.0 / 9.0, b=15.0 / 16.0, dt=1e-3, nu=nu, write_q=write_q)
    jq = None if q is None else jnp.asarray(q)
    ref_q, ref_f = pallas_mega(
        *(jnp.asarray(a) for a in (f, r, axy, uz)), jq, j1, j2, 0.02, interpret=True, **kw
    )
    tq = None if q is None else torch.from_numpy(q)
    got_q, got_f = megastep.rk3_mega_ref(
        *(torch.from_numpy(a) for a in (f, r, axy, uz)), tq, t1, t2, 0.02, **kw
    )
    assert got_f.dtype == torch.float32
    assert _rel(got_f.numpy(), ref_f) <= F32_GATE
    if write_q:
        assert _rel(got_q.numpy(), ref_q) <= F32_GATE
    else:
        assert got_q is None and ref_q is None


def _state(shape, lengths, seed=33):
    z, y, x = (np.arange(n) * (L / n) for n, L in zip(shape, lengths))
    u = jm.taylor_green(jnp.asarray(z), jnp.asarray(y), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    f0 = np.sin(x)[None, None, :] + 0.1 * rng.standard_normal(shape)
    spacing = tuple(L / n for n, L in zip(shape, lengths))
    return f0, [np.asarray(c) for c in u], spacing


def test_fused_step_float32_matches_cfd_tpu_fused():
    shape = (64, 128, 128)
    f0, u, spacing = _state(shape, (2 * math.pi,) * 3)
    j1, j2 = jsch.SCHEME4_PERIODIC, jsch.SCHEME4_D2_PERIODIC
    jderivs = jm.Derivs.single_device(spacing, j1, method="auto", second_derivative=True)
    jderivs = dataclasses.replace(
        jderivs, fused_substep=jax_fused_substep(spacing, j1, j2, interpret=True)
    )
    fj = jm.AdvectionDiffusion(jderivs, nu=1e-2).step(
        jnp.asarray(f0, jnp.float32), tuple(jnp.asarray(c, jnp.float32) for c in u), 1e-3
    )
    f, ut = tm.state_from_numpy(f0, u, CPU, torch.float32)
    tderivs = tm.Derivs.single_device(spacing, tsch.SCHEME4_PERIODIC, "auto", second_derivative=True)
    assert tderivs.fused_substep is not None
    ft = tm.AdvectionDiffusion(tderivs, nu=1e-2).step(f, ut, 1e-3)
    assert ft.dtype == torch.float32
    fj = np.asarray(fj, np.float64)
    inc = np.abs(fj - np.float32(f0)).max()
    assert np.abs(ft.numpy() - fj).max() / inc < STEP_GATE


def _three_steps(name, shape, lengths):
    f0, u, spacing = _state(shape, lengths)
    jmodel = jm.AdvectionDiffusion(
        jm.Derivs.single_device(spacing, getattr(jsch, name), "auto", second_derivative=True),
        nu=1e-2,
    )
    fj = jnp.asarray(f0)
    for _ in range(3):
        fj = jmodel.step(fj, tuple(jnp.asarray(c) for c in u), 1e-3)
    tderivs = tm.Derivs.single_device(spacing, getattr(tsch, name), "auto", second_derivative=True)
    f, ut = tm.state_from_numpy(f0, u, CPU, torch.float64)
    ft = tm.AdvectionDiffusion(tderivs, nu=1e-2).run(f, ut, 1e-3, 3)
    return tderivs, ft.numpy(), np.asarray(fj)


@pytest.mark.parametrize("name", ["SCHEME4_PERIODIC", "SCHEME6_PERIODIC"])
def test_fused_path_float64_matches_cfd_tpu_generic(name):
    derivs, got, ref = _three_steps(name, (32, 24, 40), (2 * math.pi,) * 3)
    assert derivs.fused_substep is not None and derivs.laplacian is not None
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= F64_TOL * np.abs(ref).max()


def test_non_periodic_d2_runs_generic_and_matches_cfd_tpu():
    derivs, got, ref = _three_steps("SCHEME4", (32, 24, 40), (2.0, 1.5, 3.0))
    assert derivs.fused_substep is None and derivs.laplacian is not None
    assert make_fused_substep(0.1, tsch.SCHEME4, tsch.SCHEME4_D2) is None
    assert np.abs(got - ref).max() <= F64_TOL * np.abs(ref).max()


def test_fused_substep_on_cpu_launches_nothing():
    modules = (lane, strided, adv_lap, megastep)
    before = [m.LAUNCHES for m in modules]
    f0, u, spacing = _state((16, 16, 24), (2 * math.pi,) * 3)
    f, ut = tm.state_from_numpy(f0, u, CPU, torch.float32)
    model = tm.AdvectionDiffusion(
        tm.Derivs.single_device(spacing, tsch.SCHEME4_PERIODIC, "auto", second_derivative=True)
    )
    out = model(f, ut, 1e-3)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert [m.LAUNCHES for m in modules] == before


def test_fused_substep_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="first-derivative"):
        make_fused_substep(0.1, tsch.SCHEME4_D2_PERIODIC, tsch.SCHEME4_D2_PERIODIC)
    with pytest.raises(ValueError, match="derivative_order=2"):
        make_fused_substep(0.1, tsch.SCHEME4_PERIODIC, tsch.SCHEME4_PERIODIC)
    f = torch.zeros(8, 16, 16)
    with pytest.raises(ValueError, match="periodic d2"):
        adv_lap.adv_lap_rhs(f, f, f, 0.1, 0.1, 0.1, tsch.SCHEME4, tsch.SCHEME4_D2)
    with pytest.raises(ValueError, match="3-D"):
        adv_lap.adv_lap_rhs(f[0], f[0], f[0], 0.1, 0.1, 0.1, tsch.SCHEME4, tsch.SCHEME4_D2_PERIODIC)
    with pytest.raises(ValueError, match="shape"):
        megastep.rk3_mega(f, f, f, f[:4], None, tsch.SCHEME4, tsch.SCHEME4_D2, 0.1,
                          a=0.0, b=1.0, dt=1e-3, nu=1e-3)
