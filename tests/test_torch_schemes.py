"""The port's float64 tables against the JAX package's (exact equality).

cfd_tpu_torch ports the numpy table code instead of importing it
(importing cfd_tpu pulls in jax), so every table is held equal to its
cfd_tpu counterpart: the scheme bands and RHS matrix, the Thomas and cyclic
factors, the dense operator, and the z tables of the fused substep's
Laplacian right-hand side. Tolerance: bitwise equality, or 1e-15 absolute
where the port's arithmetic order could differ.
"""

import dataclasses

import numpy as np
import pytest

import cfd_tpu.schemes as jsch
from cfd_tpu.ops import derivatives as jder
from cfd_tpu.ops import pallas_lap as jlap
from cfd_tpu.ops import tridiag as jtri

import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops import adv_lap as tlap
from cfd_tpu_torch.ops import dense as tdense
from cfd_tpu_torch.ops import tridiag as ttri

NAMES = [
    "SCHEME4",
    "SCHEME4_PERIODIC",
    "SCHEME6",
    "SCHEME6_PERIODIC",
    "SCHEME4_D2",
    "SCHEME4_D2_PERIODIC",
    "SCHEME6_D2",
    "SCHEME6_D2_PERIODIC",
]
SIZES = [32, 128, 256]


def _pair(name):
    return getattr(jsch, name), getattr(tsch, name)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_bands_and_rhs_matrix_equal(name, n):
    js, ts = _pair(name)
    for a, b in zip(jsch.lhs_bands(js, n), tsch.lhs_bands(ts, n)):
        assert np.array_equal(a, b)
    assert np.array_equal(jsch.rhs_matrix(js, n), tsch.rhs_matrix(ts, n))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_factors_equal(name, n):
    js, ts = _pair(name)
    bands = tsch.lhs_bands(ts, n)
    if ts.periodic:
        a = jtri.cyclic_factor(*bands, js.alpha, js.alpha, method="thomas")
        b = ttri.cyclic_factor(*bands, ts.alpha, ts.alpha)
        for x, y in zip(a.core, b.core):
            assert np.array_equal(x, y)
        assert np.abs(a.q - b.q).max() <= 1e-15
        assert (a.v0, a.vn, a.inv_denom) == (b.v0, b.vn, b.inv_denom)
    else:
        for x, y in zip(jtri.thomas_factor(*bands), ttri.thomas_factor(*bands)):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_dense_operator_equal(name, n):
    js, ts = _pair(name)
    assert np.array_equal(jder.dense_operator(js, n), tdense.dense_operator(ts, n))


@pytest.mark.parametrize("name", NAMES)
def test_scheme_from_dict_carries_the_tables(name):
    js, ts = _pair(name)
    carried = tsch.scheme_from_dict(dataclasses.asdict(js))
    assert carried == ts
    assert carried.right_rows == ts.right_rows
    n = 64
    assert np.array_equal(tsch.rhs_matrix(carried, n), jsch.rhs_matrix(js, n))
    for a, b in zip(tsch.lhs_bands(carried, n), jsch.lhs_bands(js, n)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [8, 64, 256])
@pytest.mark.parametrize("name", ["SCHEME4_D2_PERIODIC", "SCHEME6_D2_PERIODIC"])
def test_z_tables_equal(name, n):
    """float64 tables, cast to float32, equal cfd_tpu's float32 bit for bit."""
    js, ts = _pair(name)
    jb, jt = jlap._z_tables(js, n)
    tb, tt = tlap.z_tables(ts, n)
    assert tb.dtype == tt.dtype == np.float64
    assert np.array_equal(tb.astype(np.float32), jb)
    assert np.array_equal(tt.astype(np.float32), jt)
    with pytest.raises(ValueError, match="periodic"):
        tlap.z_tables(tsch.SCHEME4_D2, n)


def test_filter_tables_equal():
    for periodic in (False, True):
        js = jsch.get_filter(6, 0.45, periodic)
        ts = tsch.get_filter(6, 0.45, periodic)
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
        assert np.array_equal(jsch.rhs_matrix(js, 32), tsch.rhs_matrix(ts, 32))


def test_get_scheme_and_errors():
    assert tsch.get_scheme(6, True) is tsch.SCHEME6_PERIODIC
    with pytest.raises(ValueError):
        tsch.get_scheme(8)
    with pytest.raises(ValueError):
        tsch.lhs_bands(tsch.SCHEME6, 4)
