"""The CUDA kernels K1 (compact_lane), K2 (compact_strided, with its acc,
mul, solve_only and rk modes), K3 (adv_lap), K4 (rk3_mega), K5 (adv_lap3),
K6 (div_rhs), pair_subtract (K1 + K2 with acc), K7 (gradient_pair), K8
(d2_sum), K9 (lap_rhs), K10 (curl_rhs) and K13 (adv_pair); K1 and K2 also
in filter mode.

A CUDA kernel cannot run on the CPU, so its arithmetic is held here in two
ways:

* on the CPU, a numpy transcription of ``csrc/compact_common.cuh``
  (``closure_row`` + ``solve_line``) runs on the tables that
  ``ops/_native.kernel_tables`` builds for the kernels, and must equal the
  dense operator: at 1e-12 relative in float64 (the tables are right) and
  within the kernels' float32 gate, 1e-5 * max|ref|, in float32 (the
  difference-form RHS keeps the closures accurate);
* on the card (``gpu`` marker; skipped without one), each kernel against
  its plain PyTorch version at the same gate, with its launch counter.

The transcription covers the first- and second-derivative schemes and the
filters; K3-K10 run the same line solves (``compact_common.cuh``) on other
sources.
"""

import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

import cfd_tpu_torch as ct
from cfd_tpu_torch.models import (
    AdvectionDiffusion, Burgers, Derivs, NavierStokes, benchmark_field, coordinates, taylor_green,
)
from cfd_tpu_torch.ops import _native, adv_lap, dense, lane, megastep, pair, strided, vec
from cfd_tpu_torch.schemes import rhs_matrix

D1_SCHEMES = [ct.SCHEME4, ct.SCHEME4_PERIODIC, ct.SCHEME6, ct.SCHEME6_PERIODIC]
D2_SCHEMES = [ct.SCHEME4_D2, ct.SCHEME4_D2_PERIODIC, ct.SCHEME6_D2, ct.SCHEME6_D2_PERIODIC]
FILTERS = [ct.get_filter(o, 0.45, p) for o in (4, 6) for p in (False, True)]
SCHEMES = D1_SCHEMES + D2_SCHEMES + FILTERS
IDS = [s.name for s in SCHEMES]
FUSED = [(ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC), (ct.SCHEME6_PERIODIC, ct.SCHEME6_D2_PERIODIC)]
FUSED_IDS = ["pade4", "lele6"]
F32_GATE = 1e-5  # kernels' float32 tolerance, relative to max|ref|
# Second derivatives with closure rows (pade4_d2, lele6_d2) on a smooth
# field: rounding the exact RHS once to float32 and solving in float64
# already leaves 1.1e-5 of max|f''| at n = 256, since the corner of T^{-1}
# (LHS closure (1, 11) and (1, 137/13), a pivot of -0.1 and -0.05 on row 1)
# amplifies the wall rows' rounding ~15x; the float32 sweep reads 1.9e-5.
# On the card's smooth benchmark field (x cos(xy) + y sin z, f'' up to 245)
# the whole float32 arithmetic reads up to 4.8e-5 for lele6_d2 (_d2_wall_budget;
# run this file as a script for the split by cause).
# These take the gate the JAX package's fold kernels meet on d2 (5e-5,
# tests/test_second_derivative.py).
D2_WALL_GATE = 5e-5


def _gate(scheme):
    if scheme.derivative_order == 2 and not scheme.periodic:
        return D2_WALL_GATE
    return F32_GATE


def _emulate(f, scheme, dx, dtype):
    """numpy transcription of the kernels' per-line arithmetic, lines (B, n)."""
    return _emulate_sweep(_emulate_rhs(f, scheme, dx, dtype), scheme)


def _emulate_rhs(f, scheme, dx, dtype):
    """The line RHS B f / dx**order as ``LineRhs`` forms it."""
    n = f.shape[-1]
    c, _ = _native.kernel_tables(scheme, n)
    cast = np.dtype(dtype).type
    f = f.astype(dtype)
    scale = cast((1.0 / dx) ** scheme.derivative_order)
    w = [cast(v) for v in c["w"]]
    sign, center = cast(c["sign"]), cast(c["center"])
    left, lsum = c["left"].astype(dtype), c["left_sum"].astype(dtype)
    right, rsum = c["right"].astype(dtype), c["right_sum"].astype(dtype)
    rhs = np.empty_like(f)
    for i in range(n):
        fi = f[:, i]
        if not c["periodic"] and (i < c["n_rows"] or i >= n - c["n_rows"]):
            if i < c["n_rows"]:
                wt, at, s0 = left[i], (lambda m: f[:, m]), lsum[i]
            else:
                j = n - 1 - i
                wt, at, s0 = right[j], (lambda m: f[:, n - 1 - m]), rsum[j]
            if c["diff2"]:
                r = np.zeros_like(fi)
                for m in range(c["n_taps"]):
                    mid = at(m + 1)
                    r = r + wt[m] * ((at(m) - mid) + (at(m + 2) - mid))
            else:
                r = s0 * fi
                for m in range(c["n_taps"]):
                    r = r + wt[m] * (at(m) - fi)
        else:
            r = center * fi
            for k in range(1, c["K"] + 1):
                ip, im = (i + k) % n, (i - k) % n
                r = r + w[k - 1] * ((f[:, ip] - fi) + sign * (f[:, im] - fi))
        rhs[:, i] = scale * r
    return rhs


def _emulate_sweep(rhs, scheme):
    """The Thomas sweeps of ``solve_line`` on a given RHS, in its dtype."""
    n = rhs.shape[-1]
    dtype = rhs.dtype
    c, tab = _native.kernel_tables(scheme, n)
    cast = np.dtype(dtype).type
    tw, tinvd, tdu, tq, tp = tab.astype(dtype)
    y = np.empty_like(rhs)
    z = np.zeros(rhs.shape[0], dtype)
    y0 = np.zeros(rhs.shape[0], dtype)
    for i in range(n):
        z = rhs[:, i] - tw[i] * z
        y[:, i] = z
        y0 = y0 + tp[i] * z
    x = z * tinvd[n - 1]
    corr = np.zeros_like(x)
    if c["periodic"]:
        corr = cast(c["inv_denom"]) * (cast(c["v0"]) * y0 + cast(c["vn"]) * x)
    y[:, n - 1] = x - tq[n - 1] * corr
    for i in range(n - 2, -1, -1):
        x = (y[:, i] - tdu[i] * x) * tinvd[i]
        y[:, i] = x - tq[i] * corr
    return y


def _ref(f, scheme, dx):
    M = dense.dense_operator(scheme, f.shape[-1])
    return f.astype(np.float64) @ M.T / dx**scheme.derivative_order


@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_kernel_arithmetic_float64_equals_dense(scheme):
    rng = np.random.default_rng(7)
    f = rng.standard_normal((6, 64)) + 0.5
    ref = _ref(f, scheme, 0.1)
    got = _emulate(f, scheme, 0.1, np.float64)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_kernel_arithmetic_float32_within_gate(scheme):
    """Smooth offset field at n=256: the cancellation case for closures."""
    n = 256
    x = np.arange(n) * (2 * np.pi / n)
    f = (np.sin(x + np.arange(4)[:, None]) + 3.0).astype(np.float32)
    ref = _ref(f, scheme, 2 * np.pi / n)
    got = _emulate(f, scheme, 2 * np.pi / n, np.float32)
    assert np.abs(got - ref).max() <= _gate(scheme) * np.abs(ref).max()


@pytest.mark.parametrize("scheme", D2_SCHEMES[::2], ids=IDS[4:8:2])
def test_d2_closure_rows_over_second_differences(scheme):
    """The second-difference weights rebuild each closure row exactly, and
    on a smooth field through zero the float32 wall rows stay within the
    gate (their first-difference form loses ~5e-4 there)."""
    c, _ = _native.kernel_tables(scheme, 64)
    assert c["diff2"] == 1
    for row, d in zip(scheme.left_rows, c["left"]):
        stencil = np.zeros(c["n_taps"] + 2)
        for m, dm in enumerate(d[: c["n_taps"]]):
            stencil[m : m + 3] += dm * np.array([1.0, -2.0, 1.0])
        want = np.zeros_like(stencil)
        want[: len(row.rhs_stencil)] = row.rhs_stencil
        assert np.abs(stencil - want).max() <= 1e-12
    n = 256
    x = np.arange(n) * (2 * np.pi / n)
    f = np.sin(x + np.arange(4)[:, None]).astype(np.float32)
    ref = _ref(f, scheme, 2 * np.pi / n)
    got = _emulate(f, scheme, 2 * np.pi / n, np.float32)
    assert np.abs(got - ref).max() <= D2_WALL_GATE * np.abs(ref).max()
    with pytest.raises(ValueError, match="linear"):
        _native.second_differences(np.array([1.0, -1.0, 0.0, 0.0]))


def _d2_wall_budget(scheme, planes):
    """max|err| / max|ref| of the kernels' d2 arithmetic on y-lines of the
    smooth benchmark field at 256^2 (``chip_smoke.py``'s "smooth" case, on
    ``planes`` z-planes), split by cause: the exact RHS rounded once to
    float32 and solved in float64; that RHS through the float32 sweeps; the
    whole float32 transcription (RHS formed in float32 too)."""
    n = 256
    c = coordinates(n, device="cpu")
    f, _ = benchmark_field(c[:: n // planes], c, c)
    lines = f.permute(0, 2, 1).reshape(-1, n).numpy()
    dx = 2 * np.pi / n
    ref = _ref(lines, scheme, dx)
    rhs32 = (lines.astype(np.float64) @ rhs_matrix(scheme, n).T / dx**2).astype(np.float32)
    floor = np.linalg.solve(dense.lhs_matrix(scheme, n), rhs32.astype(np.float64).T).T
    got = (floor, _emulate_sweep(rhs32, scheme), _emulate(lines, scheme, dx, np.float32))
    return tuple(np.abs(g - ref).max() / np.abs(ref).max() for g in got)


@pytest.mark.parametrize("scheme", D2_SCHEMES[::2], ids=IDS[4:8:2])
def test_d2_walls_on_smooth_benchmark_field_within_gate(scheme):
    """The field on which the card reads its worst d2 error: the float32
    arithmetic stays within the d2 wall gate there too."""
    floor, _, full = _d2_wall_budget(scheme, planes=16)
    assert floor < full <= D2_WALL_GATE


def test_coef_struct_layout():
    """The ctypes struct carries each table into the C layout unchanged."""
    coef, _ = _native.kernel_tables(ct.SCHEME6, 32)
    c = _native.fill_coef(coef, 4.0)
    assert ctypes.sizeof(c) == 4 * (6 + 3 + 6 + 2 * (3 * 8 + 3))
    assert (c.n, c.K, c.periodic, c.n_rows, c.n_taps, c.diff2) == (32, 2, 0, 2, 6, 0)
    raw = np.frombuffer(bytes(c), np.float32)
    left = raw[6 + 3 + 6 :][: 3 * 8].reshape(3, 8)
    assert np.array_equal(left, coef["left"].astype(np.float32))
    assert c.scale == 4.0 and c.sign == -1.0 and c.center == 0.0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 8, 256), (3, 37, 100), (2, 3, 512), (5, 3, 7)])
@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_lane_kernel_matches_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(3)
    f = (torch.randn(shape, generator=g) + 0.5).to(cuda)
    before = lane.LAUNCHES
    got = lane.lane_derivative(f, 0.05, scheme)
    torch.cuda.synchronize()
    assert lane.LAUNCHES == before + 1
    ref = lane.lane_derivative_ref(f.double(), 0.05, scheme)
    assert _rel_err(got, ref) <= _gate(scheme)


# K1's chains (csrc/line_chains.cuh): lines of 512, 1024, 1000 (25 chains
# of 40 rows) and 8192 points, ragged line counts, with and without the acc
# epilogue; the last cases are lines that no divisor cuts into chains of 32
# rows (one chain, the whole line: 257 points, 37, 8191)
CHAIN_SHAPES = [(5, 3, 512), (37, 1024), (7, 1000), (3, 8192), (5, 257), (9, 3, 37), (2, 8191)]


@pytest.mark.gpu
@pytest.mark.parametrize("acc", [False, True], ids=["plain", "acc"])
@pytest.mark.parametrize("shape", CHAIN_SHAPES,
                         ids=[f"{s}-nb{lane.line_nb(s[-1])}" for s in CHAIN_SHAPES])
@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_lane_chains_kernel_matches_plain(cuda, scheme, shape, acc):
    g = torch.Generator(device="cpu").manual_seed(8)
    f = (torch.randn(shape, generator=g) + 0.5).to(cuda)
    a = torch.randn(shape, generator=g).to(cuda) if acc else None
    got = lane.launch(f, 0.05, scheme, a)
    torch.cuda.synchronize()
    ref = lane.lane_derivative_ref(f.double(), 0.05, scheme)
    if acc:
        ref = ref + a.double()
    assert _rel_err(got, ref) <= _gate(scheme)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "axis,shape", [(1, (4, 256, 40)), (0, (96, 5, 33)), (1, (2, 64, 1)), (0, (7, 3, 5))]
)
@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_strided_kernel_matches_plain(cuda, scheme, axis, shape):
    g = torch.Generator(device="cpu").manual_seed(4)
    f = (torch.randn(shape, generator=g) + 0.5).to(cuda)
    before = strided.LAUNCHES
    got = strided.strided_derivative(f, 0.05, scheme, axis)
    torch.cuda.synchronize()
    assert strided.LAUNCHES == before + 1
    ref = strided.strided_derivative_ref(f.double(), 0.05, scheme, axis)
    assert _rel_err(got, ref) <= _gate(scheme)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", [ct.SCHEME4, ct.SCHEME6], ids=["pade4", "lele6"])
def test_lane_kernel_line_past_48kb(cuda, scheme):
    """A line of 12288 floats (+ wrap slots) passes the 48 KB a block gets
    without opting in: K1 stages one line per block in opted-in memory."""
    n = 12288
    g = torch.Generator(device="cpu").manual_seed(6)
    f = torch.randn((3, n), generator=g)
    got = lane.lane_derivative(f.to(cuda), 0.01, scheme).cpu().double()
    ref = torch.from_numpy(ct.oracle.derivative_np(scheme, f.double().numpy(), 0.01, axis=1))
    assert _rel_err(got, ref) <= F32_GATE


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    f = torch.ones(4, 8, 64, device=cuda)
    with pytest.raises(TypeError):
        lane.lane_derivative(f.double(), 0.1, ct.SCHEME4)
    with pytest.raises(ValueError):
        strided.strided_derivative(f.transpose(0, 1), 0.1, ct.SCHEME4, 0)
    with pytest.raises(TypeError):
        ct.dfdx(f.double(), 0.1)  # 'auto' on a float64 CUDA tensor
    with pytest.raises(RuntimeError, match="compact_lane"):
        lane.lane_derivative(torch.ones(2, 60000, device=cuda), 0.1, ct.SCHEME4)


# K3 on the paired chained x phase: x-lines of 256 (8 chains), 257 (one
# chain) and 6134 (two chains of 3067 rows, one line of two families a block
# in opted-in shared memory), beside ragged and tiny ones
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6, 40, 128), (40, 96, 200), (5, 7, 9), (5, 8, 256),
                                   (5, 8, 257), (16, 64, 6134)])
@pytest.mark.parametrize("schemes", FUSED, ids=FUSED_IDS)
def test_adv_lap_kernel_matches_plain(cuda, schemes, shape):
    s1, s2 = schemes
    g = torch.Generator(device="cpu").manual_seed(8)
    f, ux, uy = (torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    before = adv_lap.LAUNCHES
    axy, r = adv_lap.adv_lap_rhs(f, ux, uy, 0.03, 0.02, 0.01, s1, s2)
    torch.cuda.synchronize()
    assert adv_lap.LAUNCHES == before + 1
    ref = adv_lap.adv_lap_rhs_ref(f.double(), ux.double(), uy.double(), 0.03, 0.02, 0.01, s1, s2)
    assert _rel_err(axy, ref[0]) <= F32_GATE
    assert _rel_err(r, ref[1]) <= F32_GATE


@pytest.mark.gpu
# nu = 1e-2 puts the Laplacian at ~1e-5 of the update; at dt * nu = 1 it is
# O(1), so a wrong d2 solve fails the gate
@pytest.mark.parametrize("nu", [1e-2, 1e3], ids=["nu1e-2", "nu1e3"])
@pytest.mark.parametrize("case", ["first", "middle", "last"])
# z-lines of 64 (two chains), 40 (one chain, ragged columns), 256 (8
# chains), 42 and the prime 257 (one chain)
@pytest.mark.parametrize("shape", [(64, 16, 128), (40, 96, 200), (256, 8, 32), (42, 16, 128),
                                   (257, 8, 40)])
@pytest.mark.parametrize("schemes", FUSED + [(ct.SCHEME4, ct.SCHEME4_D2)],
                         ids=FUSED_IDS + ["pade4_walls"])
def test_rk3_mega_kernel_matches_plain(cuda, schemes, shape, case, nu):
    s1, s2 = schemes
    g = torch.Generator(device="cpu").manual_seed(9)
    f, r, axy, uz, q = (torch.randn(shape, generator=g).to(cuda) for _ in range(5))
    q = None if case == "first" else q
    kw = dict(a=-5.0 / 9.0, b=15.0 / 16.0, dt=1e-3, nu=nu, write_q=case != "last")
    before = megastep.LAUNCHES
    got_q, got_f = megastep.rk3_mega(f, r, axy, uz, q, s1, s2, 0.02, **kw)
    torch.cuda.synchronize()
    assert megastep.LAUNCHES == before + 1
    d = [t.double() for t in (f, r, axy, uz)]
    ref_q, ref_f = megastep.rk3_mega_ref(*d, None if q is None else q.double(), s1, s2, 0.02, **kw)
    assert _rel_err(got_f, ref_f) <= F32_GATE
    if case == "last":
        assert got_q is None
    else:
        assert _rel_err(got_q, ref_q) <= F32_GATE


@pytest.mark.gpu
def test_fused_kernels_refuse_what_they_do_not_take(cuda):
    s1, s2 = FUSED[0]
    f = torch.ones(8, 16, 32, device=cuda)
    with pytest.raises(TypeError):
        adv_lap.adv_lap_rhs(f.double(), f.double(), f.double(), 0.1, 0.1, 0.1, s1, s2)
    with pytest.raises(ValueError, match="contiguous"):
        adv_lap.adv_lap_rhs(f, f.transpose(1, 2).contiguous().transpose(1, 2), f, 0.1, 0.1, 0.1, s1, s2)
    kw = dict(a=0.0, b=1.0, dt=1e-3, nu=1e-3)
    with pytest.raises(TypeError):
        megastep.rk3_mega(f.double(), f.double(), f.double(), f.double(), None, s1, s2, 0.1, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        megastep.rk3_mega(f, f, f, f, f.transpose(1, 2).contiguous().transpose(1, 2), s1, s2, 0.1, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["acc", "mul"])
@pytest.mark.parametrize("axis,shape", [(0, (64, 16, 128)), (1, (5, 96, 40)), (0, (40, 96, 200))])
@pytest.mark.parametrize("scheme", D1_SCHEMES, ids=IDS[:4])
def test_strided_epilogues_match_plain(cuda, scheme, axis, shape, mode):
    g = torch.Generator(device="cpu").manual_seed(10)
    f, m, a = (torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    before = strided.MODE_LAUNCHES[mode]
    mul = m if mode == "mul" else None
    got = strided.strided_derivative(f, -0.05, scheme, axis, acc=a, mul=mul)
    torch.cuda.synchronize()
    assert strided.MODE_LAUNCHES[mode] == before + 1
    ref = strided.strided_derivative_ref(f.double(), -0.05, scheme, axis, acc=a.double(),
                                         mul=None if mul is None else mul.double())
    assert _rel_err(got, ref) <= F32_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 16, 128), (40, 96, 200), (7, 3, 5)])
@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_leading_solve_matches_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(15)
    r = torch.randn(shape, generator=g).to(cuda)
    before = strided.MODE_LAUNCHES["solve"]
    got = strided.leading_solve(r, scheme)
    torch.cuda.synchronize()
    assert strided.MODE_LAUNCHES["solve"] == before + 1
    assert _rel_err(got, strided.leading_solve_ref(r.double(), scheme)) <= F32_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 256, 256), (40, 96, 200), (2, 7, 9)])
@pytest.mark.parametrize("scheme", D1_SCHEMES, ids=IDS[:4])
def test_pair_subtract_kernel_matches_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(11)
    f, ax, ay = (torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    before = (pair.LAUNCHES, lane.LAUNCHES, strided.LAUNCHES)
    got = pair.pair_subtract(f, ax, ay, 0.03, 0.02, scheme)
    torch.cuda.synchronize()
    assert (pair.LAUNCHES, lane.LAUNCHES, strided.LAUNCHES) == (before[0] + 1, *before[1:])
    ref = pair.pair_subtract_ref(f.double(), ax.double(), ay.double(), 0.03, 0.02, scheme)
    for g_, r_ in zip(got, ref):
        assert _rel_err(g_, r_) <= F32_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6, 40, 128), (40, 96, 200), (5, 7, 9)])
@pytest.mark.parametrize("schemes", FUSED, ids=FUSED_IDS)
def test_adv_lap3_kernel_matches_plain_and_k3(cuda, schemes, shape):
    s1, s2 = schemes
    g = torch.Generator(device="cpu").manual_seed(12)
    u = tuple(torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    before = adv_lap.LAUNCHES3
    axy, r = adv_lap.adv_lap_rhs3(u, 0.03, 0.02, 0.01, s1, s2)
    torch.cuda.synchronize()
    assert adv_lap.LAUNCHES3 == before + 1
    ref = adv_lap.adv_lap_rhs3_ref(tuple(c.double() for c in u), 0.03, 0.02, 0.01, s1, s2)
    for i in range(3):
        assert _rel_err(axy[i], ref[0][i]) <= F32_GATE
        assert _rel_err(r[i], ref[1][i]) <= F32_GATE
        # K3 on the same component: the same y phase and the same paired
        # chained x phase, so the same float32 arithmetic
        a1, r1 = adv_lap.adv_lap_rhs(u[i], u[0], u[1], 0.03, 0.02, 0.01, s1, s2)
        assert torch.equal(axy[i], a1) and torch.equal(r[i], r1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 16, 128), (40, 96, 200), (5, 7, 9)])
@pytest.mark.parametrize("scheme", [ct.SCHEME4_PERIODIC, ct.SCHEME6_PERIODIC], ids=FUSED_IDS)
def test_div_rhs_kernel_and_fused_divergence_match_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(13)
    u = tuple(torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    u64 = tuple(c.double() for c in u)
    before = (vec.LAUNCHES, strided.MODE_LAUNCHES["solve"])
    r = vec.div_rhs(*u, 0.04, 0.03, 0.02, scheme)
    d = ct.divergence(u, (0.04, 0.03, 0.02), scheme)
    torch.cuda.synchronize()
    assert (vec.LAUNCHES, strided.MODE_LAUNCHES["solve"]) == (before[0] + 2, before[1] + 1)
    assert _rel_err(r, vec.div_rhs_ref(*u64, 0.04, 0.03, 0.02, scheme)) <= F32_GATE
    ref = ct.divergence(u64, (0.04, 0.03, 0.02), scheme, method="matmul")
    assert _rel_err(d, ref) <= F32_GATE


@pytest.mark.gpu
def test_navier_stokes_step_runs_the_kernels(cuda):
    """One NS step at (16, 32, 64) on the card: every kernel of the path and
    no plain version, against the float64 plain path."""
    shape = (16, 32, 64)
    c = [coordinates(n, device=cuda) for n in shape]
    g = torch.Generator(device="cpu").manual_seed(14)
    u = tuple(v + 0.1 * torch.randn(shape, generator=g).to(cuda) for v in taylor_green(*c))
    spacing = tuple(2 * np.pi / n for n in shape)
    ns = NavierStokes.single_device(spacing, ct.SCHEME4_PERIODIC, nu=1e-2)
    u = ns.project(u)
    counters = (lane, adv_lap, megastep, vec, pair)
    before = [m.LAUNCHES for m in counters] + [adv_lap.LAUNCHES3, dict(strided.MODE_LAUNCHES)]
    out = ns.step(u, 1e-3)
    torch.cuda.synchronize()
    after = [m.LAUNCHES for m in counters] + [adv_lap.LAUNCHES3, dict(strided.MODE_LAUNCHES)]
    assert [a - b for a, b in zip(after[:5], before[:5])] == [0, 0, 9, 3, 3]
    assert after[5] - before[5] == 3
    assert {k: after[6][k] - before[6][k] for k in after[6]} == {
        "derivative": 0, "filter": 0, "acc": 3, "mul": 0, "solve": 3, "rk": 0}
    ref_ns = NavierStokes.single_device(spacing, ct.SCHEME4_PERIODIC, nu=1e-2, method="matmul")
    ref = ref_ns.step(tuple(v.double() for v in u), 1e-3)
    scale = max(v.abs().max().item() for v in ref)
    for got, want in zip(out, ref):
        assert (got.double() - want).abs().max().item() <= 1e-5 * scale
    assert ns.divergence(out).abs().max().item() <= 1e-4 * scale


@pytest.mark.gpu
def test_slice3_kernels_refuse_what_they_do_not_take(cuda):
    s1, s2 = FUSED[0]
    f = torch.ones(8, 16, 32, device=cuda)
    with pytest.raises(TypeError):
        vec.div_rhs(f.double(), f.double(), f.double(), 0.1, 0.1, 0.1, s1)
    with pytest.raises(TypeError):
        adv_lap.adv_lap_rhs3((f.double(),) * 3, 0.1, 0.1, 0.1, s1, s2)
    with pytest.raises(ValueError, match="contiguous"):
        pair.pair_subtract(f, f.transpose(1, 2).contiguous().transpose(1, 2), f, 0.1, 0.1, s1)
    with pytest.raises(TypeError):
        strided.leading_solve(f.double(), s1)
    with pytest.raises(TypeError):
        ct.divergence((f.double(),) * 3, 0.1, s1)  # 'auto' on float64 CUDA tensors


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 256, 256), (40, 96, 200), (5, 7, 9)])
@pytest.mark.parametrize("scheme", D1_SCHEMES, ids=IDS[:4])
def test_gradient_pair_kernel_matches_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(16)
    f = (torch.randn(shape, generator=g) + 0.5).to(cuda)
    before = (pair.GRADIENT_LAUNCHES, lane.LAUNCHES, strided.LAUNCHES)
    got = pair.gradient_pair(f, 0.03, 0.02, scheme)
    torch.cuda.synchronize()
    assert (pair.GRADIENT_LAUNCHES, lane.LAUNCHES, strided.LAUNCHES) == (before[0] + 1,
                                                                         *before[1:])
    ref = pair.gradient_pair_ref(f.double(), 0.03, 0.02, scheme)
    for g_, r_ in zip(got, ref):
        assert _rel_err(g_, r_) <= F32_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 256, 256), (40, 96, 200), (2, 3, 8, 9)])
@pytest.mark.parametrize("scheme", D2_SCHEMES, ids=IDS[4:8])
def test_d2_sum_kernel_matches_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(17)
    f = (torch.randn(shape, generator=g) + 0.5).to(cuda)
    before = pair.D2_SUM_LAUNCHES
    got = pair.d2_pair_sum(f, 0.03, 0.02, scheme)
    torch.cuda.synchronize()
    assert pair.D2_SUM_LAUNCHES == before + 1
    assert _rel_err(got, pair.d2_pair_sum_ref(f.double(), 0.03, 0.02, scheme)) <= _gate(scheme)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 16, 128), (40, 96, 200), (7, 5, 9)])
@pytest.mark.parametrize("scheme", [ct.SCHEME4_D2_PERIODIC, ct.SCHEME6_D2_PERIODIC],
                         ids=["pade4_d2", "lele6_d2"])
def test_lap_rhs_kernel_and_laplacian_match_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(18)
    f = (torch.randn(shape, generator=g) + 0.5).to(cuda)
    spacing = (0.04, 0.03, 0.02)
    before = (adv_lap.LAP_LAUNCHES, strided.MODE_LAUNCHES["solve"])
    r = adv_lap.lap_rhs(f, *spacing, scheme)
    lap = ct.laplacian(f, spacing, scheme)
    torch.cuda.synchronize()
    assert (adv_lap.LAP_LAUNCHES, strided.MODE_LAUNCHES["solve"]) == (before[0] + 2,
                                                                     before[1] + 1)
    assert _rel_err(r, adv_lap.lap_rhs_ref(f.double(), *spacing, scheme)) <= F32_GATE
    ref = ct.laplacian(f.double(), spacing, scheme, method="matmul")
    assert _rel_err(lap, ref) <= F32_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 16, 128), (40, 96, 200)])
@pytest.mark.parametrize("scheme", [ct.SCHEME4_D2, ct.SCHEME6_D2], ids=["pade4_d2", "lele6_d2"])
def test_walls_laplacian_runs_d2_sum_and_acc(cuda, scheme, shape):
    """K8, then K2 with acc on d2 closure rows: the non-periodic route."""
    g = torch.Generator(device="cpu").manual_seed(19)
    f = (torch.randn(shape, generator=g) + 0.5).to(cuda)
    a = torch.randn(shape, generator=g).to(cuda)
    before = (pair.D2_SUM_LAUNCHES, strided.MODE_LAUNCHES["acc"])
    lap = ct.laplacian(f, (0.04, 0.03, 0.02), scheme)
    acc = strided.strided_derivative(f, 0.04, scheme, 0, acc=a)
    torch.cuda.synchronize()
    assert (pair.D2_SUM_LAUNCHES, strided.MODE_LAUNCHES["acc"]) == (before[0] + 1,
                                                                   before[1] + 2)
    ref = ct.laplacian(f.double(), (0.04, 0.03, 0.02), scheme, method="matmul")
    assert _rel_err(lap, ref) <= D2_WALL_GATE
    ref = strided.strided_derivative_ref(f.double(), 0.04, scheme, 0, acc=a.double())
    assert _rel_err(acc, ref) <= D2_WALL_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 16, 128), (40, 96, 200), (7, 6, 9)])
@pytest.mark.parametrize("scheme", D1_SCHEMES, ids=IDS[:4])
def test_curl_kernel_and_curl_match_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(20)
    u = tuple(torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    u64 = tuple(c.double() for c in u)
    spacing = (0.04, 0.03, 0.02)
    before = (vec.CURL_LAUNCHES, strided.MODE_LAUNCHES["solve"], pair.GRADIENT_LAUNCHES)
    w = ct.curl(u, spacing, scheme)
    torch.cuda.synchronize()
    want = (1, 2, 0) if scheme.periodic else (0, 0, 1)
    after = (vec.CURL_LAUNCHES, strided.MODE_LAUNCHES["solve"], pair.GRADIENT_LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == want
    for got, ref in zip(w, ct.curl(u64, spacing, scheme, method="matmul")):
        assert _rel_err(got, ref) <= F32_GATE
    if scheme.periodic:
        got = vec.curl_rhs(*u, *spacing, scheme)
        for g_, r_ in zip(got, vec.curl_rhs_ref(*u64, *spacing, scheme)):
            assert _rel_err(g_, r_) <= F32_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", FILTERS, ids=IDS[8:])
def test_filter_field_runs_k1_and_k2_in_filter_mode(cuda, scheme):
    g = torch.Generator(device="cpu").manual_seed(21)
    f = (torch.randn((24, 40, 72), generator=g) + 3.0).to(cuda)
    before = (lane.MODE_LAUNCHES["filter"], strided.MODE_LAUNCHES["filter"])
    got = ct.filter_field(f, scheme)
    torch.cuda.synchronize()
    assert (lane.MODE_LAUNCHES["filter"], strided.MODE_LAUNCHES["filter"]) == (before[0] + 1,
                                                                               before[1] + 2)
    ref = ct.filter_field(f.double(), scheme, method="matmul")
    assert _rel_err(got, ref) <= F32_GATE


@pytest.mark.gpu
def test_vector_calculus_kernels_refuse_what_they_do_not_take(cuda):
    f = torch.ones(8, 16, 32, device=cuda)
    s1 = ct.SCHEME4_PERIODIC
    with pytest.raises(TypeError):
        pair.gradient_pair(f.double(), 0.1, 0.1, s1)
    with pytest.raises(TypeError):
        pair.d2_pair_sum(f.double(), 0.1, 0.1, ct.SCHEME4_D2)
    with pytest.raises(TypeError):
        adv_lap.lap_rhs(f.double(), 0.1, 0.1, 0.1, ct.SCHEME4_D2_PERIODIC)
    with pytest.raises(ValueError, match="contiguous"):
        vec.curl_rhs(f, f.transpose(1, 2).contiguous().transpose(1, 2), f, 0.1, 0.1, 0.1, s1)
    with pytest.raises(RuntimeError, match="gradient_pair"):
        pair.gradient_pair(torch.ones(2, 4, 20000, device=cuda), 0.1, 0.1, s1)
    with pytest.raises(TypeError):
        ct.curl((f.double(),) * 3, 0.1, s1)  # 'auto' on float64 CUDA tensors
    with pytest.raises(TypeError):
        ct.gradient(f.double(), 0.1, s1)


if __name__ == "__main__":
    # The d2 wall budget on all 256 planes of the smooth field:
    #   python tests/test_torch_kernels.py
    for s in D2_SCHEMES[::2]:
        floor, sweep, full = _d2_wall_budget(s, planes=256)
        print(f"{s.name}: f32 RHS rounding {floor:.3e}, + f32 sweeps {sweep:.3e}, "
              f"+ f32 RHS formation {full:.3e} (gate {D2_WALL_GATE:g})")


# K13 and K2's rk mode: the stepwise fused substep (ops/fused_step.py)
RK3_CASES = {"first": (0.0, 1.0 / 3.0, False), "middle": (-5.0 / 9.0, 15.0 / 16.0, True),
             "last": (-153.0 / 128.0, 8.0 / 15.0, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 16, 8192), (5, 37, 100), (2, 16, 12278)])
@pytest.mark.parametrize("scheme", D1_SCHEMES, ids=[s.name for s in D1_SCHEMES])
def test_advection_pair_kernel_matches_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(7)
    f, ux, uy = (torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    before = pair.ADV_PAIR_LAUNCHES
    got = pair.advection_pair(f, ux, uy, 0.05, 0.04, scheme)
    torch.cuda.synchronize()
    assert pair.ADV_PAIR_LAUNCHES == before + 1
    ref = pair.advection_pair_ref(f.double(), ux.double(), uy.double(), 0.05, 0.04, scheme)
    assert _rel_err(got, ref) <= F32_GATE


@pytest.mark.gpu
def test_advection_pair_kernel_rejects_lines_past_its_shared_memory(cuda):
    """The chained x phase holds a line in one block, in the card's
    opted-in shared memory: a prime line (one chain) of 65537 points (262
    KB) passes it, in K13 and in K9."""
    f = torch.zeros((5, 8, 65537), device=cuda)
    with pytest.raises(RuntimeError, match="adv_pair launch failed"):
        pair.advection_pair(f, f, f, 0.1, 0.1, ct.SCHEME4_PERIODIC)
    with pytest.raises(RuntimeError, match="lap_rhs launch failed"):
        adv_lap.lap_rhs(f, 0.1, 0.1, 0.1, ct.SCHEME4_D2_PERIODIC)


# K9 and K13 with their x phase in sub-block chains (csrc/xy_phase.cuh
# xy_chain_launch): x-lines of 8192 (128 chains of 64 rows), 512, 256, 257
# (one chain), 12278 (14 chains of 877 rows, one line a block in opted-in
# shared memory) and 8191 (prime: one chain), and the long-x path's (64,
# 128, 8192) and 256^3; K9 takes nz >= 5 and ny >= 5 for its sixth-order
# scheme, K13 ny >= 6 for SCHEME6
XY_CHAIN_LINES = [(8, 8192), (16, 512), (8, 256), (8, 257), (8, 12278), (8, 8191)]
XY_CHAIN_K9 = [(5, *s) for s in XY_CHAIN_LINES] + [(64, 128, 8192), (256, 256, 256)]
XY_CHAIN_K13 = [(3, *s) for s in XY_CHAIN_LINES] + [(64, 128, 8192), (256, 256, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", XY_CHAIN_K9,
                         ids=[f"{s}-nb{lane.line_nb(s[-1])}" for s in XY_CHAIN_K9])
@pytest.mark.parametrize("scheme", [ct.SCHEME4_D2_PERIODIC, ct.SCHEME6_D2_PERIODIC],
                         ids=["pade4_d2", "lele6_d2"])
def test_lap_rhs_chained_x_phase_matches_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(21)
    f = torch.randn(shape, generator=g).to(cuda)
    spacing = (0.04, 0.03, 0.02)
    before = adv_lap.LAP_LAUNCHES
    got = adv_lap.lap_rhs(f, *spacing, scheme)
    torch.cuda.synchronize()
    assert adv_lap.LAP_LAUNCHES == before + 1
    assert _rel_err(got, adv_lap.lap_rhs_ref(f.double(), *spacing, scheme)) <= F32_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("shape", XY_CHAIN_K13,
                         ids=[f"{s}-nb{lane.line_nb(s[-1])}" for s in XY_CHAIN_K13])
@pytest.mark.parametrize("scheme", D1_SCHEMES, ids=[s.name for s in D1_SCHEMES])
def test_advection_pair_chained_x_phase_matches_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(22)
    f, ux, uy = (torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    before = pair.ADV_PAIR_LAUNCHES
    got = pair.advection_pair(f, ux, uy, 0.05, 0.04, scheme)
    torch.cuda.synchronize()
    assert pair.ADV_PAIR_LAUNCHES == before + 1
    ref = pair.advection_pair_ref(f.double(), ux.double(), uy.double(), 0.05, 0.04, scheme)
    assert _rel_err(got, ref) <= F32_GATE


# K6 on K9's chained launch, at K9's shapes; K5 on the paired chained
# launch: x-lines of 256 (8 chains, 16 lines of two families a block), 512,
# 257 (one chain) and 6134 (two chains of 3067 rows, one line of two
# families a block in opted-in shared memory), and the NS step's 256^3
XY_CHAIN_K5 = [(5, 8, 256), (5, 16, 512), (5, 8, 257), (5, 8, 6134), (256, 256, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", XY_CHAIN_K9,
                         ids=[f"{s}-nb{lane.line_nb(s[-1])}" for s in XY_CHAIN_K9])
@pytest.mark.parametrize("scheme", [ct.SCHEME4_PERIODIC, ct.SCHEME6_PERIODIC], ids=FUSED_IDS)
def test_div_rhs_chained_x_phase_matches_plain(cuda, scheme, shape):
    g = torch.Generator(device="cpu").manual_seed(23)
    u = tuple(torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    before = vec.LAUNCHES
    got = vec.div_rhs(*u, 0.04, 0.03, 0.02, scheme)
    torch.cuda.synchronize()
    assert vec.LAUNCHES == before + 1
    ref = vec.div_rhs_ref(*(c.double() for c in u), 0.04, 0.03, 0.02, scheme)
    assert _rel_err(got, ref) <= F32_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("shape", XY_CHAIN_K5,
                         ids=[f"{s}-nb{lane.line_nb(s[-1])}" for s in XY_CHAIN_K5])
@pytest.mark.parametrize("schemes", FUSED + [(ct.SCHEME4, ct.SCHEME4_D2_PERIODIC)],
                         ids=FUSED_IDS + ["pade4_walls"])
def test_adv_lap3_paired_chained_x_phase_matches_plain(cuda, schemes, shape):
    s1, s2 = schemes
    g = torch.Generator(device="cpu").manual_seed(24)
    u = tuple(torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    before = adv_lap.LAUNCHES3
    axy, r = adv_lap.adv_lap_rhs3(u, 0.03, 0.02, 0.01, s1, s2)
    torch.cuda.synchronize()
    assert adv_lap.LAUNCHES3 == before + 1
    ref = adv_lap.adv_lap_rhs3_ref(tuple(c.double() for c in u), 0.03, 0.02, 0.01, s1, s2)
    for got, want in zip(axy + r, ref[0] + ref[1]):
        assert _rel_err(got, want) <= F32_GATE


@pytest.mark.gpu
def test_divergence_past_the_x_limit_is_the_three_derivative_sum(cuda):
    """nx = 12290 passes ``vec.div_fused_supported`` (an x-line within an x
    block's 48 KB), as the JAX routing has it: ``divergence`` returns the
    sum of three derivatives and launches no K6."""
    g = torch.Generator(device="cpu").manual_seed(25)
    u = tuple(torch.randn((5, 8, 12290), generator=g).to(cuda) for _ in range(3))
    spacing = (0.04, 0.03, 0.02)
    assert not vec.div_fused_supported(ct.SCHEME4_PERIODIC, *u[0].shape, torch.float32)
    before = vec.LAUNCHES
    got = ct.divergence(u, spacing, ct.SCHEME4_PERIODIC)
    torch.cuda.synchronize()
    assert vec.LAUNCHES == before
    ref = ct.divergence(tuple(c.double() for c in u), spacing, ct.SCHEME4_PERIODIC,
                        method="matmul")
    assert _rel_err(got, ref) <= F32_GATE


@pytest.mark.gpu
def test_chained_div_rhs_and_adv_lap3_reject_lines_past_their_shared_memory(cuda):
    """A prime line (one chain) of 65537 points passes one opted-in block:
    K6 stages one tile of it (262 KB), K5 and K3 two."""
    f = torch.zeros((5, 8, 65537), device=cuda)
    with pytest.raises(RuntimeError, match="div_rhs launch failed"):
        vec.div_rhs(f, f, f, 0.1, 0.1, 0.1, ct.SCHEME4_PERIODIC)
    with pytest.raises(RuntimeError, match="adv_lap3 launch failed"):
        adv_lap.adv_lap_rhs3((f, f, f), 0.1, 0.1, 0.1, *FUSED[0])
    with pytest.raises(RuntimeError, match="adv_lap launch failed"):
        adv_lap.adv_lap_rhs(f, f, f, 0.1, 0.1, 0.1, *FUSED[0])


@pytest.mark.gpu
def test_rk3_mega_rejects_z_lines_past_its_shared_memory(cuda):
    """K4 stages two tiles of a column's z-line: at a prime nz (one chain)
    of 29059 points they and the faces take 232,488 bytes, past the opted-in
    maximum of 232,448 that the device reports (``_native.smem_limit``,
    the kernel's own query), and ``rk3_mega_supported`` declines it; the
    prime 29033 fits."""
    s1, s2 = FUSED[0]
    kw = dict(a=0.0, b=1.0, dt=1e-3, nu=1e-3)
    limit = _native.smem_limit(cuda)
    assert megastep.tile_bytes(29033, 1) <= limit < megastep.tile_bytes(29059, 1)
    assert megastep.rk3_mega_supported(s1, s2, (29033, 1, 4), torch.float32, cuda)
    assert not megastep.rk3_mega_supported(s1, s2, (29059, 1, 4), torch.float32, cuda)
    f = torch.zeros((29059, 1, 4), device=cuda)
    with pytest.raises(RuntimeError, match="rk3_mega launch failed"):
        megastep.rk3_mega(f, f, f, f, None, s1, s2, 0.1, **kw)
    f = torch.zeros((29033, 1, 4), device=cuda)
    q, fn = megastep.rk3_mega(f, f, f, f, None, s1, s2, 0.1, **kw)
    torch.cuda.synchronize()
    assert not fn.any() and not q.any()


@pytest.mark.gpu
@pytest.mark.parametrize("nu", [1e-3, 1e3], ids=["nu1e-3", "dt_nu1"])
@pytest.mark.parametrize("case", list(RK3_CASES))
@pytest.mark.parametrize("scheme", D2_SCHEMES, ids=[s.name for s in D2_SCHEMES])
def test_rk3_solve_update_kernel_matches_plain(cuda, scheme, case, nu):
    """dt * nu = 1 makes the solve O(1) of q' and f'."""
    a, b, has_q = RK3_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(8)
    r, adv, fin, q = (torch.randn((64, 9, 33), generator=g).to(cuda) for _ in range(4))
    q = q if has_q else None
    kw = dict(a=a, b=b, dt=1e-3, nu=nu)
    before = strided.MODE_LAUNCHES["rk"]
    got = strided.rk3_solve_update(r, adv, q, fin, scheme, **kw)
    torch.cuda.synchronize()
    assert strided.MODE_LAUNCHES["rk"] == before + 1
    ref = strided.rk3_solve_update_ref(r.double(), adv.double(),
                                       None if q is None else q.double(), fin.double(), scheme, **kw)
    for g_, r_ in zip(got, ref):
        assert _rel_err(g_, r_) <= _gate(scheme)


@pytest.mark.gpu
def test_burgers_takes_the_stepwise_head_on_long_x_lines(cuda):
    """(8, 16, 8192): K5 and K3 do not fit, so each component's substep is
    K13 + K9 + K4; the step matches the generic step."""
    shape, dx = (8, 16, 8192), 2 * math.pi / 16
    g = torch.Generator(device="cpu").manual_seed(9)
    u = tuple((0.5 * torch.randn(shape, generator=g)).to(cuda) for _ in range(3))
    derivs = Derivs.single_device(dx, ct.SCHEME4_PERIODIC, "auto", second_derivative=True)
    before = (pair.ADV_PAIR_LAUNCHES, adv_lap.LAUNCHES, adv_lap.LAUNCHES3)
    got = Burgers(derivs, nu=1e-2).step(u, 1e-4)
    torch.cuda.synchronize()
    assert pair.ADV_PAIR_LAUNCHES == before[0] + 9
    assert (adv_lap.LAUNCHES, adv_lap.LAUNCHES3) == before[1:]
    generic = dataclasses.replace(derivs, fused_substep=None, fused_substep_vec=None)
    want = Burgers(generic, nu=1e-2).step(u, 1e-4)
    scale = max(c.abs().max().item() for c in want)
    assert max((a - b).abs().max().item() for a, b in zip(got, want)) <= 1e-5 * scale


# The staged y phase of csrc/xy_phase.cuh (xy_y_kernel), which K3, K5, K6,
# K9 and K13 share: a 512 x 512 plane (16 chains of 32 rows a y-line; 16
# columns a block for a pair, 32 for one tile), the long-x shape (64, 128,
# 8192), a prime y-line (one chain), the fewest rows the schemes take (6),
# and y-lines of 4096 points (128 chains: 2 columns a block for a pair,
# one a thread at a time; 4 for one tile); ragged column blocks at nx = 40.
Y_PHASE_SHAPES = [(5, 512, 512), (64, 128, 8192), (5, 257, 40), (5, 6, 40), (5, 4096, 12)]
Y_PHASE_KERNELS = ("K3", "K5", "K6", "K9", "K13")


def _xy_kernel_pairs(kernel, u, u64, spacing):
    """(got, plain float64) output pairs of one xy kernel on fields ``u``,
    with the launch counter that counts it."""
    (s1, s2), dz, dy, dx = FUSED[0], *spacing
    if kernel == "K3":
        got = adv_lap.adv_lap_rhs(u[2], u[0], u[1], dz, dy, dx, ct.SCHEME4, s2)
        ref = adv_lap.adv_lap_rhs_ref(u64[2], u64[0], u64[1], dz, dy, dx, ct.SCHEME4, s2)
        return list(zip(got, ref)), (adv_lap, "LAUNCHES")
    if kernel == "K5":
        got = adv_lap.adv_lap_rhs3(u, dz, dy, dx, s1, s2)
        ref = adv_lap.adv_lap_rhs3_ref(u64, dz, dy, dx, s1, s2)
        return list(zip(got[0] + got[1], ref[0] + ref[1])), (adv_lap, "LAUNCHES3")
    if kernel == "K6":
        got = vec.div_rhs(*u, dz, dy, dx, s1)
        return [(got, vec.div_rhs_ref(*u64, dz, dy, dx, s1))], (vec, "LAUNCHES")
    if kernel == "K9":
        got = adv_lap.lap_rhs(u[0], dz, dy, dx, ct.SCHEME6_D2_PERIODIC)
        ref = adv_lap.lap_rhs_ref(u64[0], dz, dy, dx, ct.SCHEME6_D2_PERIODIC)
        return [(got, ref)], (adv_lap, "LAP_LAUNCHES")
    got = pair.advection_pair(u[0], u[1], u[2], dy, dx, ct.SCHEME4)
    ref = pair.advection_pair_ref(u64[0], u64[1], u64[2], dy, dx, ct.SCHEME4)
    return [(got, ref)], (pair, "ADV_PAIR_LAUNCHES")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", Y_PHASE_SHAPES,
                         ids=[f"{s}-nby{lane.line_nb(s[1])}" for s in Y_PHASE_SHAPES])
@pytest.mark.parametrize("kernel", Y_PHASE_KERNELS)
def test_staged_y_phase_matches_plain(cuda, kernel, shape):
    g = torch.Generator(device="cpu").manual_seed(26)
    u = tuple(torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    u64 = tuple(c.double() for c in u)
    counted = {}
    for module, name in ((adv_lap, "LAUNCHES"), (adv_lap, "LAUNCHES3"), (vec, "LAUNCHES"),
                         (adv_lap, "LAP_LAUNCHES"), (pair, "ADV_PAIR_LAUNCHES")):
        counted[module, name] = getattr(module, name)
    outs, counter = _xy_kernel_pairs(kernel, u, u64, (0.04, 0.03, 0.02))
    torch.cuda.synchronize()
    assert getattr(*counter) == counted[counter] + 1
    for got, want in outs:
        assert _rel_err(got, want) <= F32_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", Y_PHASE_KERNELS)
def test_y_phase_walks_columns_past_the_shared_memory(cuda, kernel, monkeypatch):
    """Prime y-lines of 29,059 points (one chain): a pair's two tiles of one
    column and their faces take 232,488 bytes, past the opt-in maximum of
    232,448 that the device reports, so K3 and K5 raise before they launch
    (``lane.y_tables``; their predicates decline the shape); one tile (K6,
    K9, K13) takes half and is staged, a column a block, and matches the
    plain version, whose float64 y derivative is here the banded solve of
    the same compact system (``dense.dense_derivative`` along the last axis
    of the transposed field: the dense 29,059-point operator takes minutes
    to build)."""
    limit = _native.smem_limit(cuda)
    assert lane.y_tile_bytes(29059, 1, 1) <= limit < lane.y_tile_bytes(29059, 1, 2)
    dense_derivative = dense.dense_derivative

    def banded_y(f, d, scheme, axis):
        if axis % f.ndim == f.ndim - 2:
            return dense_derivative(f.transpose(-1, -2).contiguous(), d, scheme, -1).transpose(
                -1, -2)
        return dense_derivative(f, d, scheme, axis)

    for module in (adv_lap, vec, pair):
        monkeypatch.setattr(module, "dense_derivative", banded_y)
    g = torch.Generator(device="cpu").manual_seed(27)
    u = tuple(torch.randn((5, 29059, 8), generator=g).to(cuda) for _ in range(3))
    u64 = tuple(c.double() for c in u)
    if kernel in ("K3", "K5"):
        with pytest.raises(ValueError, match="29059 points in 2 tiles takes 232488 bytes"):
            _xy_kernel_pairs(kernel, u, u64, (0.04, 0.03, 0.02))
        return
    outs, _ = _xy_kernel_pairs(kernel, u, u64, (0.04, 0.03, 0.02))
    torch.cuda.synchronize()
    for got, want in outs:
        assert _rel_err(got, want) <= F32_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 512])
def test_model_paths_stage_every_y_phase(cuda, n):
    """A Navier–Stokes step (K5, K6) at n^3, and at 256^3 an advection–
    diffusion step (K3) and a Burgers step (K5): each launches its fused
    xy kernels, whose y phase is staged."""
    c = [coordinates(n, device=cuda) for _ in range(3)]
    u = taylor_green(*c)
    dx, dt = 2 * math.pi / n, 0.25 * 2 * math.pi / n
    launches = (adv_lap.LAUNCHES, adv_lap.LAUNCHES3, vec.LAUNCHES)
    NavierStokes.single_device(dx, ct.SCHEME4_PERIODIC, nu=1 / 1600).step(u, dt)
    want = [0, 3, 3]
    if n == 256:
        derivs = Derivs.single_device(dx, ct.SCHEME4_PERIODIC, "auto", second_derivative=True)
        AdvectionDiffusion(derivs, nu=1e-3).step(u[0], u, dt)
        Burgers(derivs, nu=1e-3).step(u, dt)
        want = [3, 6, 3]
    torch.cuda.synchronize()
    assert [a - b for a, b in zip((adv_lap.LAUNCHES, adv_lap.LAUNCHES3, vec.LAUNCHES),
                                  launches)] == want
