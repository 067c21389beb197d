"""The port's derivatives against the JAX package and the float64 oracles.

Inputs are made by numpy from a seed and handed to both packages.

* float64: the port's plain path (dense operator, CPU) against
  ``cfd_tpu.dfdx/dfdy/dfdz(method="pcr")`` and against both packages'
  scipy oracles — 1e-10 relative to max|ref|.
* float32: the port's plain path against the Pallas kernels it replaces,
  run in interpret mode as ``tests/test_leading.py`` runs them —
  2e-5 * max|ref| (the f32-recurrence tolerance of those kernels' own
  tests, doubled for the second f32 path on the other side). Second
  derivatives against the fold kernels at 5e-5 * max|ref|, the gate those
  kernels meet on d2 in ``tests/test_second_derivative.py``.
"""

import dataclasses
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu
import cfd_tpu.schemes as jsch
from cfd_tpu.oracle import derivative_np as jax_oracle
from cfd_tpu.ops.pallas_lane import lane_derivative as pallas_lane
from cfd_tpu.ops.pallas_leading import leading_derivative as pallas_leading
from cfd_tpu.ops.pallas_sublane import sublane_derivative as pallas_sublane

import cfd_tpu_torch as ct
import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.oracle import derivative_np as port_oracle

NAMES = ["SCHEME4", "SCHEME4_PERIODIC", "SCHEME6", "SCHEME6_PERIODIC"]
D2_NAMES = ["SCHEME4_D2", "SCHEME4_D2_PERIODIC", "SCHEME6_D2", "SCHEME6_D2_PERIODIC"]
F64_TOL = 1e-10
F32_TOL = 2e-5
D2_F32_TOL = 5e-5
AXES = {"dfdx": -1, "dfdy": -2, "dfdz": -3}
D2_AXES = {"d2fdx2": -1, "d2fdy2": -2, "d2fdz2": -3}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("op", list(AXES))
@pytest.mark.parametrize("name", NAMES)
def test_plain_float64_matches_jax_and_oracles(name, op):
    js, ts = getattr(jsch, name), getattr(tsch, name)
    f = np.random.default_rng(11).standard_normal((20, 24, 28)) + 0.5
    dx = 0.07
    got = getattr(ct, op)(torch.from_numpy(f), dx, ts).numpy()
    ref_jax = np.asarray(getattr(cfd_tpu, op)(jnp.asarray(f), dx, js, method="pcr"))
    assert _rel(got, ref_jax) <= F64_TOL
    axis = AXES[op] % 3
    assert _rel(got, jax_oracle(js, f, dx, axis=axis)) <= F64_TOL
    assert _rel(port_oracle(ts, f, dx, axis=axis), jax_oracle(js, f, dx, axis=axis)) <= F64_TOL


@pytest.mark.parametrize("name", NAMES)
def test_gradient_is_three_single_axis_calls(name):
    js, ts = getattr(jsch, name), getattr(tsch, name)
    f = np.random.default_rng(12).standard_normal((16, 20, 24))
    spacing = (0.3, 0.2, 0.1)
    got = ct.gradient(torch.from_numpy(f), spacing, ts)
    ref = cfd_tpu.gradient(jnp.asarray(f), spacing, js, method="pcr")
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) <= F64_TOL


def _pallas_case(kernel, scheme, f32):
    if kernel == "lane_fold":
        return pallas_lane(f32, 0.02, scheme, interpret=True)
    if kernel == "lane_roll":
        return pallas_lane(f32, 0.02, scheme, interpret=True, fold=False)
    if kernel == "sublane":
        return pallas_sublane(f32, 0.02, scheme, axis=1, interpret=True)
    return pallas_leading(f32, 0.02, scheme, interpret=True)


PALLAS = {
    # kernel: (shape, axis of the derivative)
    "lane_fold": ((4, 8, 256), 2),
    "lane_roll": ((2, 2, 512), 2),
    "sublane": ((2, 256, 128), 1),
    "leading": ((128, 8, 128), 0),
}


@pytest.mark.parametrize("kernel", list(PALLAS))
@pytest.mark.parametrize("name", NAMES)
def test_plain_float32_matches_pallas_interpret(name, kernel):
    js, ts = getattr(jsch, name), getattr(tsch, name)
    shape, axis = PALLAS[kernel]
    f = (np.random.default_rng(13).standard_normal(shape) + 0.5).astype(np.float32)
    ref = np.asarray(_pallas_case(kernel, js, jnp.asarray(f)))
    got = ct.derivative(torch.from_numpy(f), 0.02, ts, axis=axis).numpy()
    assert got.dtype == np.float32
    assert _rel(got, ref) <= F32_TOL


@pytest.mark.parametrize("method", ["auto", "kernel", "matmul"])
def test_methods_agree_on_cpu(method):
    """On a CPU tensor every method is the plain path: no kernel launches."""
    from cfd_tpu_torch.ops import lane, strided

    f = torch.from_numpy(np.random.default_rng(14).standard_normal((8, 12, 16)))
    before = (lane.LAUNCHES, strided.LAUNCHES)
    for op in AXES:
        got = getattr(ct, op)(f, 0.1, ct.SCHEME4, method=method)
        ref = getattr(ct, op)(f, 0.1, ct.SCHEME4, method="matmul")
        assert torch.equal(got, ref)
    assert (lane.LAUNCHES, strided.LAUNCHES) == before


def test_rejects_second_derivative_and_unknown_method():
    """As ``cfd_tpu``: ``derivative`` takes d1 and d2 schemes and filters
    (no spacing scale), and only the second-derivative ops check the order;
    the kernels' tables serve no other order."""
    f = torch.zeros(8, 8, 32)
    with pytest.raises(ValueError, match="derivative_order"):
        ct.dfdx(f, 0.1, dataclasses.replace(tsch.SCHEME4, derivative_order=3))
    g = torch.randn(8, 8, 32, dtype=torch.float64)
    filt = tsch.get_filter(6, 0.45, True)
    assert torch.equal(ct.dfdx(g, 0.1, filt), ct.filter_field(g, filt, axis=-1))
    with pytest.raises(ValueError):
        ct.dfdx(f, 0.1, method="pcr")
    with pytest.raises(ValueError, match="derivative_order"):
        ct.d2fdx2(f, 0.1, tsch.SCHEME4)
    with pytest.raises(ValueError, match="derivative_order"):
        ct.laplacian(f, 0.1, tsch.SCHEME6)
    assert ct.dfdx(f, 0.1, tsch.SCHEME4_D2).shape == f.shape


@pytest.mark.parametrize("op", list(D2_AXES))
@pytest.mark.parametrize("name", D2_NAMES)
def test_plain_float64_d2_matches_jax_and_oracles(name, op):
    js, ts = getattr(jsch, name), getattr(tsch, name)
    f = np.random.default_rng(15).standard_normal((20, 24, 28)) + 0.5
    dx = 0.07
    got = getattr(ct, op)(torch.from_numpy(f), dx, ts).numpy()
    ref_jax = np.asarray(getattr(cfd_tpu, op)(jnp.asarray(f), dx, js, method="pcr"))
    assert _rel(got, ref_jax) <= F64_TOL
    axis = D2_AXES[op] % 3
    assert _rel(got, jax_oracle(js, f, dx, axis=axis)) <= F64_TOL
    assert _rel(port_oracle(ts, f, dx, axis=axis), jax_oracle(js, f, dx, axis=axis)) <= F64_TOL


@pytest.mark.parametrize("name", D2_NAMES)
def test_laplacian_matches_jax(name):
    js, ts = getattr(jsch, name), getattr(tsch, name)
    f = np.random.default_rng(16).standard_normal((16, 20, 24))
    spacing = (0.3, 0.2, 0.1)
    got = ct.laplacian(torch.from_numpy(f), spacing, ts).numpy()
    ref = np.asarray(cfd_tpu.laplacian(jnp.asarray(f), spacing, js, method="pcr"))
    assert _rel(got, ref) <= F64_TOL
    parts = sum(jax_oracle(js, f, h, axis=a) for a, h in enumerate(spacing))
    assert _rel(got, parts) <= F64_TOL


D2_PALLAS = {
    # kernel: (shape, axis), the shapes of tests/test_second_derivative.py
    "lane_fold": ((16, 256), 1),
    "sublane_fold_z": ((256, 6, 4), 0),
    "sublane_fold_y": ((2, 256, 128), 1),
}


@pytest.mark.parametrize("kernel", list(D2_PALLAS))
@pytest.mark.parametrize("name", D2_NAMES)
def test_plain_float32_d2_matches_pallas_fold_interpret(name, kernel):
    js, ts = getattr(jsch, name), getattr(tsch, name)
    shape, axis = D2_PALLAS[kernel]
    n = shape[axis]
    dx = 2 * np.pi / n
    f = (np.random.default_rng(17).standard_normal(shape) + 0.7).astype(np.float32)
    if kernel == "lane_fold":
        ref = pallas_lane(jnp.asarray(f), dx, js, interpret=True)
    else:
        ref = pallas_sublane(jnp.asarray(f), dx, js, axis=axis, interpret=True)
    got = ct.derivative(torch.from_numpy(f), dx, ts, axis=axis).numpy()
    assert got.dtype == np.float32
    assert _rel(got, np.asarray(ref)) <= D2_F32_TOL
