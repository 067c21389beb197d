"""The slice end to end: the port's RK3 advection–diffusion against cfd_tpu's.

Both models start from the same numpy state, carried onto the port with
``state_from_numpy``, and take 3 RK3 steps in float64: the JAX package
with ``Derivs.single_device(..., method="auto")`` (PCR on the CPU), the
port with its plain path. Tolerance 1e-10 relative to max|f|.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu.models as jm
import cfd_tpu.schemes as jsch

import cfd_tpu_torch.models as tm
import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops import lane, strided

TOL = 1e-10
CPU = torch.device("cpu")


def _coords(n, length):
    return np.arange(n) * (length / n)


def _run_both(name, shape, lengths, steps=3, dt=1e-3, nu=1e-3):
    z, y, x = (_coords(n, L) for n, L in zip(shape, lengths))
    spacing = tuple(L / n for n, L in zip(shape, lengths))
    u = jm.taylor_green(jnp.asarray(z), jnp.asarray(y), jnp.asarray(x))
    rng = np.random.default_rng(21)
    f0 = np.sin(x)[None, None, :] + 0.1 * rng.standard_normal(shape)

    jmodel = jm.AdvectionDiffusion(
        jm.Derivs.single_device(spacing, getattr(jsch, name), method="auto"), nu=nu
    )
    fj = jnp.asarray(f0)
    for _ in range(steps):
        fj = jmodel.step(fj, u, dt)

    f, ut = tm.state_from_numpy(f0, [np.asarray(c) for c in u], CPU, torch.float64)
    tmodel = tm.AdvectionDiffusion(
        tm.Derivs.single_device(spacing, getattr(tsch, name), method="auto"), nu=nu
    )
    ft = tmodel.run(f, ut, dt, steps)
    return ft.numpy(), np.asarray(fj)


@pytest.mark.parametrize(
    "name,shape,lengths",
    [
        ("SCHEME4_PERIODIC", (32, 32, 32), (2 * math.pi,) * 3),
        ("SCHEME6_PERIODIC", (32, 32, 32), (2 * math.pi,) * 3),
        ("SCHEME4", (64, 32, 128), (2.0, 1.5, 3.0)),
    ],
)
def test_rk3_slice_matches_cfd_tpu(name, shape, lengths):
    got, ref = _run_both(name, shape, lengths)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_rhs_matches_cfd_tpu():
    n = 32
    c = _coords(n, 2 * math.pi)
    u = jm.taylor_green(jnp.asarray(c), jnp.asarray(c), jnp.asarray(c))
    f0 = np.cos(2 * c)[:, None, None] * np.sin(c)[None, :, None] + np.sin(c)
    jmodel = jm.AdvectionDiffusion(jm.Derivs.single_device(2 * math.pi / n), nu=0.05)
    tmodel = tm.AdvectionDiffusion(tm.Derivs.single_device(2 * math.pi / n), nu=0.05)
    f, ut = tm.state_from_numpy(f0, [np.asarray(v) for v in u], CPU, torch.float64)
    ref = np.asarray(jmodel.rhs(jnp.asarray(f0), u))
    got = tmodel.rhs(f, ut).numpy()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_fields_match_cfd_tpu():
    z, y, x = _coords(8, 2.0), _coords(12, 3.0), _coords(16, 2 * math.pi)
    jz, jy, jx = (jnp.asarray(a) for a in (z, y, x))
    tz, ty, tx = (torch.from_numpy(a) for a in (z, y, x))
    for jv, tv in zip(jm.taylor_green(jz, jy, jx, t=0.5, nu=0.1),
                      tm.taylor_green(tz, ty, tx, t=0.5, nu=0.1)):
        assert tv.shape == (8, 12, 16)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-15)
    (jf, jd), (tf, td) = jm.sine_field(jz, jy, jx, k=2.0), tm.sine_field(tz, ty, tx, k=2.0)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-15)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-15)
    (jf, jg), (tf, tg) = jm.benchmark_field(jz, jy, jx), tm.benchmark_field(tz, ty, tx)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-14)
    for a, b in zip(tg, jg):
        assert a.shape == (8, 12, 16)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-14)


def test_coordinates_on_device():
    c = tm.coordinates(8, device=CPU, dtype=torch.float64, length=4.0)
    assert c.device == CPU and c.dtype == torch.float64
    np.testing.assert_allclose(c.numpy(), np.arange(8) * 0.5)


def test_kernel_method_on_cpu_counts_no_launches():
    """A CPU run of the slice takes the plain path and launches nothing."""
    n = 16
    c = tm.coordinates(n, device=CPU)
    model = tm.AdvectionDiffusion(
        tm.Derivs.single_device(2 * math.pi / n, tsch.SCHEME4_PERIODIC, "kernel")
    )
    before = (lane.LAUNCHES, strided.LAUNCHES)
    f = model(tm.sine_field(c, c, c)[0], tm.taylor_green(c, c, c), 1e-3)
    assert f.dtype == torch.float32 and torch.isfinite(f).all()
    assert (lane.LAUNCHES, strided.LAUNCHES) == before
