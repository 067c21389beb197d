"""Compact filters (derivative_order=0 schemes) in the port against cfd_tpu.

Inputs are made by numpy from a seed and handed to both packages. On the
CPU the port's K1 and K2 wrappers run their plain versions (dense
operators), so:

* float32: the plain filter against the Pallas fold kernels (x, y) and the
  leading kernel (z) in filter mode, in interpret mode, at
  ``tests/test_filters.py::test_fold_kernels_filter``'s shapes, 2e-5 *
  max|ref| (a filter has no 1/dx amplification: the f32 recurrence gate;
  along z against the float64 oracle, and 5e-5 against the leading kernel,
  whose own error on non-periodic filters is up to 3.5e-5);
* float64: ``filter_field`` on one axis and on all three against
  ``cfd_tpu.filter_field``, 1e-10 relative: the same operator in another
  order, so only rounding separates them;
* the filter's properties, as ``tests/test_filters.py`` states them for the
  JAX package: constants kept exactly, the Nyquist mode removed, a resolved
  mode kept, damping monotone in the wavenumber.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfd_tpu
import cfd_tpu.schemes as jsch
from cfd_tpu.oracle import derivative_np
from cfd_tpu.ops.pallas_lane import lane_derivative as pallas_lane
from cfd_tpu.ops.pallas_leading import leading_derivative as pallas_leading
from cfd_tpu.ops.pallas_sublane import sublane_derivative as pallas_sublane

import cfd_tpu_torch as ct
import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops import _native, lane, strided

F32_GATE = 2e-5
LEADING_GATE = 5e-5  # the JAX leading kernel's own filter error is up to 3.5e-5
F64_TOL = 1e-10
FILTERS = [(order, periodic) for order in (4, 6) for periodic in (False, True)]
IDS = [f"filter{o}_{'periodic' if p else 'walls'}" for o, p in FILTERS]
SHAPE = (16, 12, 20)


def _both(order, periodic, alpha=0.45):
    return jsch.get_filter(order, alpha, periodic), tsch.get_filter(order, alpha, periodic)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("order,periodic", FILTERS, ids=IDS)
def test_plain_float32_matches_fold_and_leading_kernels_interpret(order, periodic):
    js, ts = _both(order, periodic)
    rng = np.random.default_rng(60)
    n = 256
    f = (rng.standard_normal((8, n)) + 3.0).astype(np.float32)  # offset: no demeaning
    ref_x = pallas_lane(jnp.asarray(f), 1.0, js, interpret=True)
    got_x = lane.lane_derivative(torch.from_numpy(f), 1.0, ts)
    assert got_x.dtype == torch.float32
    assert _rel(got_x.numpy(), ref_x) <= F32_GATE
    f3 = np.ascontiguousarray(f.T[:, :, None] * np.ones((1, 1, 4), np.float32))  # (n, 8, 4)
    ref_y = pallas_sublane(jnp.asarray(f3), 1.0, js, axis=0, interpret=True)
    got_y = strided.strided_derivative(torch.from_numpy(f3), 1.0, ts, 0)
    assert _rel(got_y.numpy(), ref_y) <= F32_GATE
    # the leading kernel's plain mode with a filter: z of a (nz, ny, nx)
    # field. Its substructured chains meet the identity closure rows of a
    # non-periodic filter at 1.0e-5 (filter4) and 3.5e-5 (filter6) of the
    # float64 oracle here, so the port is held to the oracle at the gate and
    # to the kernel at LEADING_GATE
    fz = (rng.standard_normal((64, 8, 128)) + 3.0).astype(np.float32)
    ref_z = pallas_leading(jnp.asarray(fz), 1.0, js, interpret=True)
    got_z = strided.strided_derivative(torch.from_numpy(fz), 1.0, ts, 0)
    assert _rel(got_z.numpy(), derivative_np(js, fz.astype(np.float64), 1.0)) <= F32_GATE
    assert _rel(got_z.numpy(), ref_z) <= LEADING_GATE


@pytest.mark.parametrize("axis", [-1, -2, -3, None], ids=["x", "y", "z", "all"])
@pytest.mark.parametrize("order,periodic", FILTERS, ids=IDS)
def test_filter_field_float64_matches_cfd_tpu(order, periodic, axis):
    js, ts = _both(order, periodic)
    f = np.random.default_rng(61).standard_normal(SHAPE)
    ref = np.asarray(cfd_tpu.filter_field(jnp.asarray(f), js, axis=axis))
    got = ct.filter_field(torch.from_numpy(f), ts, axis=axis)
    assert got.dtype == torch.float64 and got.shape == SHAPE
    assert np.abs(got.numpy() - ref).max() <= F64_TOL * np.abs(ref).max()


@pytest.mark.parametrize("order,periodic", FILTERS, ids=IDS)
def test_constants_preserved_exactly(order, periodic):
    out = ct.filter_field(torch.full((8, 12, 64), 3.7, dtype=torch.float64),
                          tsch.get_filter(order, 0.45, periodic))
    assert (out - 3.7).abs().max().item() <= 1e-12


@pytest.mark.parametrize("order", [4, 6])
def test_nyquist_annihilated(order):
    n = 128
    saw = torch.from_numpy((-1.0) ** np.arange(n)[None, None, :] * np.ones((2, 2, 1)))
    fs = ct.filter_field(saw, tsch.get_filter(order, 0.45, True), axis=-1)
    assert fs.abs().max().item() < 1e-12
    # closed lines: the identity rows' unfiltered values decay into the
    # interior at the LHS recurrence rate, so the mode is removed away from
    # the walls
    fs = ct.filter_field(saw, tsch.get_filter(order, 0.45, False), axis=-1)
    assert fs[..., n // 2 - 6: n // 2 + 6].abs().max().item() < 1e-9


@pytest.mark.parametrize("order,tol", [(4, 3e-8), (6, 2e-11)])
def test_resolved_mode_preserved(order, tol):
    """G(k) = 1 - O(k^order): the lowest sine mode passes at truncation, and
    every mode is scaled by the filter's transfer function."""
    n = 128
    x = 2 * math.pi * np.arange(n) / n
    scheme = tsch.get_filter(order, 0.45, True)
    for m, bound in ((1, tol), (16, 1e-12)):
        f = np.sin(m * x)[None, None, :] * np.ones((2, 2, 1))
        ff = ct.filter_field(torch.from_numpy(f), scheme, axis=-1).numpy()
        gain = 1.0 if m == 1 else tsch.transfer_function(scheme, m * 2 * math.pi / n)
        assert np.abs(ff - gain * f).max() < bound


def test_transfer_function_monotone_damping():
    n = 64
    scheme = tsch.get_filter(6, 0.4, True)
    x = 2 * math.pi * np.arange(n) / n
    gains = []
    for m in (1, 8, 16, 24, 31):
        f = torch.from_numpy(np.sin(m * x)[None, None, :] * np.ones((1, 1, 1)))
        gains.append(ct.filter_field(f, scheme, axis=-1).abs().max().item())
    assert all(g1 >= g2 - 1e-12 for g1, g2 in zip(gains, gains[1:])), gains
    assert gains[0] > 1 - 1e-5 and gains[-1] < 0.15
    assert all(0 <= g <= 1 + 1e-12 for g in gains)


def test_filter_tables_keep_the_constant_part():
    """A filter's rows sum to 1 + 2 alpha (interior) and 1 (identity
    closure rows): the difference form's constant terms carry it, and the
    kernels' table scale is 1 whatever the spacing."""
    scheme = tsch.get_filter(6, 0.45, False)
    c, _ = _native.kernel_tables(scheme, 64)
    assert c["diff2"] == 0 and c["n_rows"] == 3 and c["n_taps"] == 3
    assert c["center"] == pytest.approx(1.0 + 2 * 0.45, abs=1e-14)
    assert np.array_equal(c["left_sum"], np.ones(3))
    assert np.array_equal(c["left"][:, :3], np.eye(3))
    assert np.array_equal(c["right"], c["left"])
    coef, _ = _native.launch_tables(scheme, 64, 0.01, torch.device("cpu"))
    assert coef.scale == 1.0


def test_filter_field_rejects_non_filter_scheme_and_counts_nothing_on_cpu():
    with pytest.raises(ValueError, match="not a filter"):
        ct.filter_field(torch.zeros(4, 4, 32), ct.SCHEME4)
    with pytest.raises(ValueError, match="alpha"):
        ct.get_filter(6, 0.6, True)
    with pytest.raises(ValueError, match="order"):
        ct.get_filter(8, 0.4, True)
    before = (lane.LAUNCHES, strided.LAUNCHES, dict(lane.MODE_LAUNCHES),
              dict(strided.MODE_LAUNCHES))
    out = ct.filter_field(torch.randn(8, 12, 16), ct.get_filter(4, 0.45, True))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (lane.LAUNCHES, strided.LAUNCHES, dict(lane.MODE_LAUNCHES),
            dict(strided.MODE_LAUNCHES)) == before
