"""The plain reference and the frozen counts, on the CPU."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import counts
from portbench.reference import ops, schemes


def _dense(alpha, rhs, n, periodic=True):
    # T^{-1} B of a periodic tridiagonal scheme, from (offset, weight) pairs
    t = np.eye(n)
    b = np.zeros((n, n))
    for i in range(n):
        t[i, (i - 1) % n] = t[i, (i + 1) % n] = alpha
        for off, w in rhs:
            b[i, (i + off) % n] += w
    return np.linalg.solve(t, b)


def test_bounded_dfdx_orders():
    # sin -> cos on [0, 1] (a phase, so that f''''(0) != 0): 4th order inside, 3rd
    # at the closure rows
    errs = []
    for n in (33, 65, 129, 257):
        x = np.linspace(0.0, 1.0, n)
        d = schemes.d1_matrix(n, x[1] - x[0])
        e = np.abs(d @ np.sin(3 * x + 1) - 3 * np.cos(3 * x + 1))
        errs.append((e[0], e[n // 2]))
    edge = [math.log2(a[0] / b[0]) for a, b in zip(errs, errs[1:])]
    middle = [math.log2(a[1] / b[1]) for a, b in zip(errs, errs[1:])]
    assert all(2.8 < o < 3.3 for o in edge), edge
    assert all(3.8 < o < 4.3 for o in middle), middle


def test_periodic_symbols_are_the_dense_operators():
    n, h = 12, 0.3
    theta = 2 * np.pi * np.fft.fftfreq(n)
    modes = np.exp(1j * np.outer(np.arange(n), theta))  # columns: exp(i k x_j)
    d1 = _dense(0.25, [(1, 0.75), (-1, -0.75)], n) / h
    d2 = _dense(0.1, [(1, 1.2), (-1, 1.2), (0, -2.4)], n) / h**2
    np.testing.assert_allclose(d1 @ modes, modes * (1j * schemes.d1_symbol(theta) / h),
                               atol=1e-12)
    np.testing.assert_allclose(d2 @ modes, modes * (-schemes.d2_symbol(theta) / h**2), atol=1e-11)
    np.testing.assert_allclose(schemes.d1_matrix(n, h, periodic=True), d1, atol=1e-12)


def test_projection_zeroes_the_compact_divergence():
    n, h = 12, 2 * np.pi / 12
    g = torch.Generator().manual_seed(5)
    u = tuple(torch.randn((n, n, n), generator=g, dtype=torch.float64) for _ in range(3))
    p = ops.Periodic((n, n, n), h, ops.FLOAT64, "cpu").project(u)
    d = torch.as_tensor(schemes.d1_matrix(n, h, periodic=True))
    div = (torch.einsum("ij,zyj->zyi", d, p[0]) + torch.einsum("ij,zjx->zix", d, p[1])
           + torch.einsum("ij,jyx->iyx", d, p[2]))
    assert float(div.abs().max()) < 1e-12 * float(max(c.abs().max() for c in u))
    again = ops.Periodic((n, n, n), h, ops.FLOAT64, "cpu").project(p)
    assert max(float((a - b).abs().max()) for a, b in zip(again, p)) < 1e-13


def test_spectrum_sums_to_the_kinetic_energy():
    n = 10
    ref = ops.Periodic((n, n, n), 2 * np.pi / n, ops.FLOAT64, "cpu")
    g = torch.Generator().manual_seed(2)
    u = tuple(torch.randn((n, n, n), generator=g, dtype=torch.float64) for _ in range(3))
    assert float(ref.energy_spectrum(u).sum()) == pytest.approx(float(ref.kinetic_energy(u)),
                                                                rel=1e-13)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12, 3.14159265])
    r = ops.tf32_round(x)
    assert r.tolist()[:4] == [1.0, 1.0, 1.0 + 4 * 2**-11, -1.0]  # ties to even
    bits = r.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    assert float(((r - x) / x).abs().max()) <= 2**-11


def test_counts_from_shapes():
    pts = 8 * 8 * 8
    assert counts.BYTES_PER_POINT == {"compact_lane": 4 * 2, "compact_strided": 4 * 2,
                                      "gradient_pair": 4 * 3, "adv_lap3": 4 * (3 + 6)}
    per_step = sum(counts.k4_launch_bytes(pts, s, c) for s in range(3) for c in range(3))
    # reads f, r, axy (+ uz unless f is uz, + q after the first stage), writes f' (+ q')
    assert per_step == 4 * pts * ((6 + 6 + 5) + (7 + 7 + 6) + (6 + 6 + 5))
    assert counts.ns_step_bytes(pts) == 4 * pts * 30
    fft = 5 * math.log2(pts)
    assert counts.ns_step_flops((8, 8, 8)) == pytest.approx(3 * pts * (468 + 15 + 21 + 161 + fft + 2))
    assert counts.DERIVS_A_CALL == {"dfdx": 1, "gradient": 3}
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12) == pytest.approx(1.0)
