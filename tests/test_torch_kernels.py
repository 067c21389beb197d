"""The CUDA kernels K1 (compact_lane) and K2 (compact_strided).

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
"""

import ctypes

import numpy as np
import pytest
import torch

import cfd_tpu_torch as ct
from cfd_tpu_torch.ops import _native, dense, lane, strided

SCHEMES = [ct.SCHEME4, ct.SCHEME4_PERIODIC, ct.SCHEME6, ct.SCHEME6_PERIODIC]
IDS = [s.name for s in SCHEMES]
F32_GATE = 1e-5  # kernels' float32 tolerance, relative to max|ref|


def _emulate(f, scheme, dx, dtype):
    """numpy transcription of the kernels' per-line arithmetic, lines (B, n)."""
    n = f.shape[-1]
    c, tab = _native.kernel_tables(scheme, n)
    cast = np.dtype(dtype).type
    f = f.astype(dtype)
    scale = cast((1.0 / dx) ** scheme.derivative_order)
    w = [cast(v) for v in c["w"]]
    sign, center = cast(c["sign"]), cast(c["center"])
    left, lsum = c["left"].astype(dtype), c["left_sum"].astype(dtype)
    right, rsum = c["right"].astype(dtype), c["right_sum"].astype(dtype)
    tw, tinvd, tdu, tq, tp = tab.astype(dtype)
    rhs = np.empty_like(f)
    for i in range(n):
        fi = f[:, i]
        if not c["periodic"] and i < c["n_rows"]:
            r = lsum[i] * fi
            for m in range(c["n_taps"]):
                r = r + left[i, m] * (f[:, m] - fi)
        elif not c["periodic"] and i >= n - c["n_rows"]:
            j = n - 1 - i
            r = rsum[j] * fi
            for m in range(c["n_taps"]):
                r = r + right[j, m] * (f[:, n - 1 - m] - fi)
        else:
            r = center * fi
            for k in range(1, c["K"] + 1):
                ip, im = (i + k) % n, (i - k) % n
                r = r + w[k - 1] * ((f[:, ip] - fi) + sign * (f[:, im] - fi))
        rhs[:, i] = scale * r
    y = np.empty_like(f)
    z = np.zeros(f.shape[0], dtype)
    y0 = np.zeros(f.shape[0], dtype)
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
    return f.astype(np.float64) @ dense.dense_operator(scheme, f.shape[-1]).T / dx


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
    assert np.abs(got - ref).max() <= F32_GATE * np.abs(ref).max()


def test_coef_struct_layout():
    """The ctypes struct carries each table into the C layout unchanged."""
    coef, _ = _native.kernel_tables(ct.SCHEME6, 32)
    c = _native._fill(coef, 4.0)
    assert ctypes.sizeof(c) == 4 * (5 + 3 + 6 + 2 * (3 * 8 + 3))
    assert (c.n, c.K, c.periodic, c.n_rows, c.n_taps) == (32, 2, 0, 2, 6)
    raw = np.frombuffer(bytes(c), np.float32)
    left = raw[5 + 3 + 6 :][: 3 * 8].reshape(3, 8)
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
    assert _rel_err(got, ref) <= F32_GATE


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
    assert _rel_err(got, ref) <= F32_GATE


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
