"""K1's sub-block Thomas chains on long x-lines (``csrc/line_chains.cuh``),
held on the CPU.

A CUDA kernel cannot run here, so the chained form is held through its
tables and a numpy transcription of its arithmetic, on lines of n in
{512, 1024, 8192} (the chains ``ops/lane.line_nb`` picks: 16, 32 and 128
sub-blocks, of 32, 32 and 64 rows) and of n in {7, 37, 257, 8191}, which
no divisor cuts into chains of 32 rows (one chain, the whole line, whose
periodic wrap the 2 x 2 cyclic reduced system closes), for SCHEME4 and
SCHEME6 with and without period,
the two d2 schemes of SCHEME4 and the sixth-order filter at alpha = 0.45:

* the periodic ``line_block_tables``' reduced inverse times its cyclic
  reduced matrix is the identity at 1e-12, and the non-periodic ones are
  ``local_block_tables`` of a shard that is first and last;
* ``_chains``, a float64 transcription of the kernel (the RHS rows as
  ``ChainRhs`` forms them, closure rows from f on a non-periodic line and
  the wrap on a periodic one; each sub-block's forward sweep with its
  ``t0`` face against its kind's rows of ``lane.chain_table``; each
  chain's window of reduced weights dotted with the line's faces; the
  backward sweeps with the intra update), equals the float64 operator at
  1e-10 of max|ref|: the dense operator for n <= 1024, the banded solve
  of the stencil RHS at 8192 (the dense operator is half a GB there);
* in float32 it stays within K1's gates: 1e-5 of max|ref|, 5e-5 for a
  second derivative with closure rows;
* at n = 512 in float32 it matches ``cfd_tpu``'s ``lane_derivative`` on
  the roll form (``_lane_kernel``, Pallas in interpret mode) at 2e-5, the
  tolerance of the port's other interpret tests of that kernel
  (``tests/test_torch_derivatives.py``).

Run this file as a script for each scheme's float32 budget.
"""

import numpy as np
import pytest
import torch

import cfd_tpu_torch as ct
from cfd_tpu_torch.ops import _native, dense, lane, tridiag
from cfd_tpu_torch.ops.rhs import compact_rhs
from cfd_tpu_torch.parallel import dist_tables as tdt
from cfd_tpu_torch.schemes import lhs_bands

SCHEMES = {
    "SCHEME4": ct.SCHEME4, "SCHEME4_PERIODIC": ct.SCHEME4_PERIODIC, "SCHEME6": ct.SCHEME6,
    "SCHEME6_PERIODIC": ct.SCHEME6_PERIODIC, "SCHEME4_D2": ct.SCHEME4_D2,
    "SCHEME4_D2_PERIODIC": ct.SCHEME4_D2_PERIODIC, "SCHEME6_D2_PERIODIC": ct.SCHEME6_D2_PERIODIC,
    "filter6": ct.get_filter(6, 0.45, periodic=False),
    "filter6_periodic": ct.get_filter(6, 0.45, periodic=True),
}
NS = [512, 1024, 8192]
ONE_CHAIN_NS = [7, 37, 257, 8191]
LINES = {512: 6, 1024: 4, 8192: 2, 7: 5, 37: 5, 257: 5, 8191: 2}
DX = 0.05
F32_GATE = 1e-5  # K1's gate, relative to max|ref|
D2_WALL_GATE = 5e-5  # K1's gate for second derivatives with closure rows
INTERPRET_TOL = 2e-5  # tests/test_torch_derivatives.py's F32_TOL


def _gate(scheme):
    return D2_WALL_GATE if scheme.derivative_order == 2 and not scheme.periodic else F32_GATE


def _field(n, seed):
    return np.random.default_rng(seed).standard_normal((LINES[n], n)) + 0.5


def _rhs(f, scheme, dtype, dx=DX):
    """The scaled RHS rows, lines (L, n), as ``ChainRhs`` forms them: the
    interior stencil in difference form over the line wrapped at its ends,
    then the closure rows of a non-periodic line from f."""
    n = f.shape[-1]
    c, _ = _native.kernel_tables(scheme, n)
    cast = np.dtype(dtype).type
    f = f.astype(dtype)
    scale = cast((1.0 / dx) ** scheme.derivative_order)
    r = cast(c["center"]) * f
    for k in range(1, c["K"] + 1):
        r = r + cast(c["w"][k - 1]) * ((np.roll(f, -k, -1) - f)
                                      + cast(c["sign"]) * (np.roll(f, k, -1) - f))
    r = r * scale
    if scheme.periodic:
        return r
    for side in ("left", "right"):
        for j in range(c["n_rows"]):
            i = j if side == "left" else n - 1 - j
            at = (lambda m: f[:, m]) if side == "left" else (lambda m: f[:, n - 1 - m])
            wt = c[side][j].astype(dtype)
            if c["diff2"]:
                v = np.zeros_like(f[:, 0])
                for m in range(c["n_taps"]):
                    mid = at(m + 1)
                    v = v + wt[m] * ((at(m) - mid) + (at(m + 2) - mid))
            else:
                fi = f[:, i]
                v = cast(c[side + "_sum"][j]) * fi
                for m in range(c["n_taps"]):
                    v = v + wt[m] * (at(m) - fi)
            r[:, i] = scale * v
    return r


def _chains(f, scheme, dtype):
    """numpy transcription of K1's chained form on lines (L, n), in
    ``dtype``: ``solve_line_chain`` for every chain of every line, the
    chains of all lines side by side (each with its own kind's rows), each
    in the kernel's order of operations."""
    return _solve_chains(_rhs(f, scheme, dtype), scheme, dtype)


def _solve_chains(r, scheme, dtype, nb=None):
    """``solve_chain`` on the formed RHS rows ``r`` of lines (L, n), in
    ``dtype``, in ``nb`` sub-blocks a line (``lane.line_nb(n)`` if None),
    on ``lane.chain_table(scheme, n, nb)``."""
    n = r.shape[-1]
    shape = r.shape
    nb = lane.line_nb(n) if nb is None else nb
    bz = n // nb
    table, h, win = lane.chain_table(scheme, n, nb)
    table = table.astype(dtype)
    rows = 3 * (bz + 2)
    bwd = table[: 4 * rows].reshape(3, bz + 2, 4)
    fwd = table[4 * rows : 6 * rows].reshape(3, bz + 2, 2)
    assert not bwd[:, [0, -1]].any() and not fwd[:, [0, -1]].any()
    red = table[6 * rows :].reshape(2, win, nb)
    kinds = [0 if k == 0 else (2 if k == nb - 1 else 1) for k in range(nb)]
    bwd, fwd = bwd[kinds, 1:-1], fwd[kinds, 1:-1]  # (nb, bz, 4), (nb, bz, 2)
    r = r.astype(dtype).reshape(-1, nb, bz)
    m = 2 * nb
    zs = np.empty_like(r)
    z = np.zeros(r.shape[:2], dtype)
    ff = np.zeros(r.shape[:2], dtype)
    for i in range(bz):  # forward sweeps and faces
        z = r[:, :, i] - fwd[:, i, 0] * z
        ff = ff + fwd[:, i, 1] * r[:, :, i]
        zs[:, :, i] = z
    faces = np.empty((r.shape[0], m), dtype)
    faces[:, 0::2] = -ff
    faces[:, 1::2] = -(z * bwd[:, bz - 1, 0])
    # each chain's window of reduced weights dotted with the line's faces
    k = np.arange(nb)
    c0 = (2 * k - h) % m if scheme.periodic else np.clip(2 * k - h, 0, m - win)
    alpha = np.zeros(r.shape[:2], dtype)
    beta = np.zeros(r.shape[:2], dtype)
    for j in range(win):
        fj = faces[:, (c0 + j) % m]
        alpha = alpha + red[0, j] * fj
        beta = beta + red[1, j] * fj
    out = np.empty_like(r)  # the backward sweeps with the intra update
    x = zs[:, :, bz - 1] * bwd[:, bz - 1, 0]
    for i in range(bz - 1, -1, -1):
        if i < bz - 1:
            x = (zs[:, :, i] - bwd[:, i, 1] * x) * bwd[:, i, 0]
        out[:, :, i] = x + alpha * bwd[:, i, 2] + beta * bwd[:, i, 3]
    return out.reshape(shape)


def _exact(f, scheme):
    """The float64 operator on lines (L, n)."""
    n = f.shape[-1]
    if n <= 1024:
        return f @ dense.dense_operator(scheme, n).T / DX ** scheme.derivative_order
    rhs = compact_rhs(torch.from_numpy(f.T.copy()), DX, scheme)
    dl, d, du = lhs_bands(scheme, n)
    if scheme.periodic:
        factors = tridiag.cyclic_factor(dl, d, du, scheme.alpha, scheme.alpha)
    else:
        factors = tridiag.thomas_factor(dl, d, du)
    return tridiag.solve(factors, rhs, 0).numpy().T


def _rel(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


CASES = [(name, n) for name in SCHEMES for n in NS + ONE_CHAIN_NS]
IDS = [f"{name}-{n}" for name, n in CASES]


@pytest.mark.parametrize("n", NS + ONE_CHAIN_NS)
@pytest.mark.parametrize("name", [k for k in SCHEMES if SCHEMES[k].periodic])
def test_periodic_reduced_inverse(name, n):
    scheme = SCHEMES[name]
    nb = lane.line_nb(n)
    t = tdt.line_block_tables(scheme, n, nb)
    bz = n // nb
    R = np.zeros((2 * nb, 2 * nb))
    uh, lh = t.uh.reshape(nb, bz), t.lh.reshape(nb, bz)
    for b in range(nb):  # summed: on a ring of one sub-block the wrap meets its own faces
        R[2 * b, [2 * b, 2 * b + 1]] += uh[b, 0], lh[b, 0]
        R[2 * b, (2 * b - 1) % (2 * nb)] -= 1.0
        R[2 * b + 1, [2 * b, 2 * b + 1]] += uh[b, -1], lh[b, -1]
        R[2 * b + 1, (2 * b + 2) % (2 * nb)] -= 1.0
    assert np.abs(t.rinv @ R - np.eye(2 * nb)).max() <= 1e-12
    assert not (t.uh == 0).all() and not (t.lh == 0).all()


@pytest.mark.parametrize("name", [k for k in SCHEMES if not SCHEMES[k].periodic])
def test_nonperiodic_tables_are_a_first_and_last_shard(name):
    scheme = SCHEMES[name]
    got = tdt.line_block_tables(scheme, 512, 16)
    want = tdt.local_block_tables(scheme, 512, True, True, 16)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_line_nb():
    assert [lane.line_nb(n) for n in (7, 63, 64, 100, 256, 257, 512, 1000, 8192, 12288)] == [
        1, 1, 2, 2, 8, 1, 16, 25, 128, 128]


@pytest.mark.parametrize("name,n", CASES, ids=IDS)
def test_chains_float64_equal_operator(name, n):
    scheme = SCHEMES[name]
    f = _field(n, seed=n + len(name))
    assert _rel(_chains(f, scheme, np.float64), _exact(f, scheme)) <= 1e-10


@pytest.mark.parametrize("name,n", CASES, ids=IDS)
def test_chains_float32_within_gate(name, n):
    scheme = SCHEMES[name]
    f = _field(n, seed=n + len(name)).astype(np.float32)
    assert _rel(_chains(f, scheme, np.float32), _exact(f.astype(np.float64), scheme)) <= _gate(
        scheme)


@pytest.mark.parametrize("name", ["SCHEME4", "SCHEME4_PERIODIC", "SCHEME6", "SCHEME6_PERIODIC"])
def test_chains_match_pallas_roll_form_interpret(name):
    jnp = pytest.importorskip("jax.numpy")
    import cfd_tpu.schemes as jsch
    from cfd_tpu.ops.pallas_lane import lane_derivative as pallas_lane

    f = (np.random.default_rng(13).standard_normal((4, 512)) + 0.5).astype(np.float32)
    ref = np.asarray(pallas_lane(jnp.asarray(f), DX, getattr(jsch, name), interpret=True,
                                 fold=False))
    assert _rel(_chains(f, SCHEMES[name], np.float32), ref) <= INTERPRET_TOL


if __name__ == "__main__":
    for name, scheme in SCHEMES.items():
        worst = max((_rel(_chains(f, scheme, np.float32), _exact(f.astype(np.float64), scheme)), n)
                    for n in NS + ONE_CHAIN_NS for f in [_field(n, seed=n + len(name)).astype(np.float32)])
        print(f"{name}: float32 chains {worst[0]:.3e} of max|ref| (worst at n = {worst[1]}), "
              f"gate {_gate(scheme):.0e}")
