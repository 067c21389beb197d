"""K9 (``lap_rhs``) and K13 (``advection_pair``) with their x phase in K1's
sub-block chains (``csrc/xy_phase.cuh`` ``xy_chain_launch``, on
``csrc/line_chains.cuh``), held on the CPU.

A CUDA kernel cannot run here, so the chained x phase is held through a
float64/float32 numpy transcription of what a launch does:

* the block sizing of ``xy_chain_launch`` (L lines of ``lane.line_nb(nx)``
  chains a block, fewer until the tile, its faces and, for K9, the lines'
  T_z rows fit 48 KB, at least one; whole warps before the chains where
  they are fewer than 128, which stage and write back with them);
* the staging: ``walk_chains``' incremental index map, checked to equal the
  direct one and to be a bijection of a block's elements onto its tile's
  chain slots; K9 stages ``T_z sx`` (``TzRow.at``: three planes, wrapped),
  K13 ``sx``;
* the solve: each staged line through ``tests/test_torch_lane_chains.py``'s
  ``_chains`` (the transcription of ``solve_line_chain`` on
  ``lane.chain_table``), read from and written back to the tile;
* the epilogue: ``out += tile`` (K9) or ``out += mx * tile`` (K13) over the
  same walk, onto the y phase, taken from the plain version.

It must equal the plain versions ``adv_lap.lap_rhs_ref`` and
``pair.advection_pair_ref`` at 1e-10 of max|ref| in float64 and stay within
1e-5 in float32, at x-lines of 8192 (128 chains of 64 rows), 512, 256,
257 (one chain) and 12278 (14 chains of 877 rows; one line a block in
opted-in shared memory): for K9 SCHEME4_D2_PERIODIC and
SCHEME6_D2_PERIODIC, for K13 SCHEME4, SCHEME4_PERIODIC and SCHEME6. At
x-lines past 1024 points the float64 plain versions take their x
derivative as the banded solve of the same compact system
(``dense.dense_derivative``; their dense x operator is half a GB at 8192
and takes minutes to build), held here against the dense operator. Planes and y-lines are the fewest
the schemes take (nz >= 5 for K9's z stencil, ny >= 6 for SCHEME6).

Both plain versions are held against ``cfd_tpu``'s Pallas kernels in
interpret mode at 512-point x-lines (the roll-form regime), at the
smallest shapes those kernels take (y-lines a multiple of 128), at the
tolerances of ``tests/test_torch_vec_calculus.py`` and
``tests/test_torch_stepwise.py``.
"""

import functools

import numpy as np
import pytest
import torch

import cfd_tpu_torch as ct
from cfd_tpu_torch.ops import adv_lap, dense, lane, pair
from test_torch_lane_chains import DX, _chains

K9_SCHEMES = {"SCHEME4_D2_PERIODIC": ct.SCHEME4_D2_PERIODIC,
              "SCHEME6_D2_PERIODIC": ct.SCHEME6_D2_PERIODIC}
K13_SCHEMES = {"SCHEME4": ct.SCHEME4, "SCHEME4_PERIODIC": ct.SCHEME4_PERIODIC,
               "SCHEME6": ct.SCHEME6}
K13_SHAPES = [(2, 8, 8192), (4, 16, 512), (4, 8, 256), (3, 8, 257), (2, 8, 12278)]
K9_SHAPES = [(5, 8, 8192), (5, 16, 512), (5, 8, 256), (5, 8, 257), (5, 8, 12278)]
DZ, DY = 0.07, 0.03  # DX (0.05) is the chain transcription's
F64_TOL = 1e-10
F32_GATE = 1e-5  # the kernels' float32 gate, relative to max|ref|

CHAIN_THREADS = 256  # XY_CHAIN_THREADS
STAGERS = 128  # XY_CHAIN_STAGERS
SMEM = 48 * 1024  # XY_X_SMEM: what a block stages without opting in
TZROW_BYTES = 32  # sizeof(TzRow): three floats, padding, two long longs


def _lines_per_block(n, nb, rhs):
    """``xy_chain_launch``'s L: XY_CHAIN_THREADS / nb lines, fewer until
    ``xy_chain_bytes`` fits 48 KB, at least one."""
    def nbytes(L):
        return (TZROW_BYTES * L if rhs else 0) + 4 * ((n // nb) * ((L * nb) | 1) + 2 * L * nb)
    L = CHAIN_THREADS // nb
    while L > 1 and nbytes(L) > SMEM:
        L -= 1
    return L


def _threads(chains):
    """``xy_chain_x``'s block size: the chains, after whole warps that
    bring the block to at least XY_CHAIN_STAGERS threads."""
    return chains + (-(-(STAGERS - chains) // 32) * 32 if chains < STAGERS else 0)


def _walk(count, n, nb, L, tiles=1):
    """``walk_chains`` for a block of L lines (of ``tiles`` families): (e,
    at, l) of every element below ``count``, each of the block's threads'
    (i, k, l) moved on without a division."""
    bz, T = n // nb, _threads(tiles * L * nb)
    cs = (tiles * L * nb) | 1
    dl, rem = divmod(T, n)
    dk, di = divmod(rem, bz)
    t = np.arange(T)
    l = t // n
    k = (t - l * n) // bz
    i = t - l * n - k * bz
    es, ats, ls = [], [], []
    e = t.copy()
    while True:
        live = e < count
        if not live.any():
            break
        es.append(e[live])
        ats.append((i * cs + l * nb + k)[live])
        ls.append(l[live])
        i = i + di
        wrap = i >= bz
        i = np.where(wrap, i - bz, i)
        k = k + wrap + dk
        wrap = k >= nb
        k = np.where(wrap, k - nb, k)
        l = l + wrap + dl
        e = e + T
    return np.concatenate(es), np.concatenate(ats), np.concatenate(ls)


@functools.lru_cache(maxsize=None)
def _check_walk(count, n, nb, L, tiles=1):
    """The walk equals the direct index map and is a bijection of the
    block's elements onto its tile's chain slots of the lines it holds
    (the first family's, where ``tiles`` families share the tile; checked
    once a block shape)."""
    e, at, l = _walk(count, n, nb, L, tiles)
    bz, cs = n // nb, (tiles * L * nb) | 1
    assert np.array_equal(np.sort(e), np.arange(count))
    ll, r = np.divmod(e, n)
    kk, ii = np.divmod(r, bz)
    assert np.array_equal(l, ll) and np.array_equal(at, ii * cs + ll * nb + kk)
    slots = (np.arange(bz)[:, None] * cs + np.arange(count // n * nb)[None, :]).ravel()
    assert np.array_equal(np.sort(at), np.sort(slots))
    return e, at, l


def _tz(f, scheme, dtype):
    """T_z f as ``TzRow.at`` forms it, t0 f[p - 1] + t1 f[p] + t2 f[p + 1]
    with the planes wrapped, in ``dtype``."""
    _, ttab = adv_lap.z_tables(scheme, f.shape[0])
    t = ttab.astype(dtype)[:, :, None, None]
    return t[:, 0] * np.roll(f, 1, 0) + t[:, 1] * f + t[:, 2] * np.roll(f, -1, 0)


def _x_phase(sx, out, mx, scheme, dtype):
    """The chained x phase of one family: stage ``sx`` (lines of the field,
    (lines, n)) block by block into the chain layout, solve every staged
    line, and add it, times ``mx`` where given, into ``out`` (in place)."""
    lines, n = sx.shape
    nb = lane.line_nb(n)
    bz = n // nb
    L = _lines_per_block(n, nb, mx is None)
    cs = (L * nb) | 1
    blocks = []
    for line0 in range(0, lines, L):
        nl = min(L, lines - line0)
        e, at, l = _check_walk(nl * n, n, nb, L)
        tile = np.full(bz * cs, np.nan, dtype)
        tile[at] = sx[line0:line0 + nl].ravel()[e]
        blocks.append((line0, nl, e, at, tile))
    # every chain of a line reads only its line's slots: solve all lines at once
    staged = np.concatenate([t.reshape(bz, cs)[:, :nl * nb].reshape(bz, nl, nb)
                             .transpose(1, 2, 0).reshape(nl, n) for _, nl, _, _, t in blocks])
    solved = _chains(staged, scheme, dtype)
    row = 0
    for line0, nl, e, at, tile in blocks:
        t = tile.reshape(bz, cs)
        t[:, :nl * nb] = solved[row:row + nl].reshape(nl, nb, bz).transpose(2, 0, 1).reshape(
            bz, nl * nb)
        row += nl
        g = line0 * n + e
        v = tile[at]
        out.reshape(-1)[g] += v if mx is None else mx.reshape(-1)[g] * v


def k9_chained(f, dz, dy, scheme, dtype):
    """K9 with its x phase transcribed (x spacing DX): the y phase, B_z f +
    D2y (T_z f), from the plain version; then the chained x phase on T_z f."""
    f = f.astype(dtype)
    ft = torch.from_numpy(f)
    y = (dense.dense_apply("rhs", ft, scheme, 0, float(dz) ** 2)
         + dense.dense_derivative(dense.dense_apply("lhs", ft, scheme, 0), dy, scheme, -2))
    out = y.numpy().copy()
    _x_phase(_tz(f, scheme, dtype).reshape(-1, f.shape[-1]), out, None, scheme, dtype)
    return out


def k13_chained(f, ux, uy, dy, scheme, dtype):
    """K13 with its x phase transcribed (x spacing DX): the y phase, uy D1y
    f, from the plain version; then the chained x phase on f, times ux."""
    f, ux, uy = (a.astype(dtype) for a in (f, ux, uy))
    out = (torch.from_numpy(uy) * dense.dense_derivative(torch.from_numpy(f), dy, scheme, -2))
    out = out.numpy().copy()
    _x_phase(f.reshape(-1, f.shape[-1]), out, ux, scheme, dtype)
    return out


def _fields(shape, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) + 0.5 for _ in range(count)]


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


def test_banded_x_equals_the_dense_operator():
    """``dense.dense_derivative`` in float64 past ``BANDED_PAST`` points
    (the banded solve) against the dense operator's product."""
    n = dense.BANDED_PAST + 1
    f = torch.from_numpy(_fields((3, 4, n), 1, 1)[0])
    filters = [ct.get_filter(order, 0.45, periodic) for order in (4, 6) for periodic in (0, 1)]
    for scheme in (*K9_SCHEMES.values(), *K13_SCHEMES.values(), ct.SCHEME4_D2, ct.SCHEME6_D2,
                   *filters):
        want = dense.dense_apply("derivative", f, scheme, -1, DX ** scheme.derivative_order)
        assert _rel(dense.dense_derivative(f, DX, scheme, -1), want) <= F64_TOL


def test_lines_per_block():
    # (n, nb, rhs) -> L: 256 threads a block, cut to 48 KB
    assert lane.line_nb(8192) == 128 and _lines_per_block(8192, 128, True) == 1
    assert _lines_per_block(512, 16, True) == 16 and _lines_per_block(256, 8, True) == 32
    assert _lines_per_block(257, 1, True) == 45 and _lines_per_block(257, 1, False) == 47
    # blocks of few chains stage with whole warps more
    assert [_threads(c) for c in (1, 14, 45, 97, 127, 128, 256)] == [129, 142, 141, 129, 159,
                                                                    128, 256]
    assert lane.line_nb(12278) == 14 and _lines_per_block(12278, 14, False) == 1


@pytest.mark.parametrize("shape", K9_SHAPES, ids=[f"{s}" for s in K9_SHAPES])
@pytest.mark.parametrize("name", K9_SCHEMES)
def test_lap_rhs_chained_x_phase(name, shape):
    scheme = K9_SCHEMES[name]
    (f,) = _fields(shape, 1, seed=shape[-1] + len(name))
    ref = adv_lap.lap_rhs_ref(torch.from_numpy(f), DZ, DY, DX, scheme).numpy()
    assert _rel(k9_chained(f, DZ, DY, scheme, np.float64), ref) <= F64_TOL
    assert _rel(k9_chained(f, DZ, DY, scheme, np.float32), ref) <= F32_GATE


@pytest.mark.parametrize("shape", K13_SHAPES, ids=[f"{s}" for s in K13_SHAPES])
@pytest.mark.parametrize("name", K13_SCHEMES)
def test_advection_pair_chained_x_phase(name, shape):
    scheme = K13_SCHEMES[name]
    f, ux, uy = _fields(shape, 3, seed=shape[-1] + 2 * len(name))
    ref = pair.advection_pair_ref(*map(torch.from_numpy, (f, ux, uy)), DY, DX, scheme).numpy()
    assert _rel(k13_chained(f, ux, uy, DY, scheme, np.float64), ref) <= F64_TOL
    assert _rel(k13_chained(f, ux, uy, DY, scheme, np.float32), ref) <= F32_GATE


@pytest.mark.parametrize("name", K9_SCHEMES)
def test_lap_rhs_ref_matches_pallas_interpret_on_512_point_lines(name):
    """``tests/test_torch_vec_calculus.py``'s tolerance (2e-5) at the
    fewest planes the Pallas kernel takes for both schemes (an even count)."""
    jnp = pytest.importorskip("jax.numpy")
    import cfd_tpu.schemes as jsch
    from cfd_tpu.ops.pallas_lap import lap_rhs as pallas_lap_rhs

    (f,) = _fields((6, 128, 512), 1, seed=75)
    f = f.astype(np.float32)
    ref = pallas_lap_rhs(jnp.asarray(f), DZ, DY, DX, getattr(jsch, name), interpret=True)
    got = adv_lap.lap_rhs(torch.from_numpy(f), DZ, DY, DX, K9_SCHEMES[name])
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 2e-5


@pytest.mark.parametrize("name", K13_SCHEMES)
def test_advection_pair_ref_matches_pallas_interpret_on_512_point_lines(name):
    """``tests/test_torch_stepwise.py``'s tolerance (1e-5)."""
    jnp = pytest.importorskip("jax.numpy")
    import cfd_tpu.schemes as jsch
    from cfd_tpu.ops.pallas_pair import advection_pair as pallas_advection_pair

    f, ux, uy = (a.astype(np.float32) for a in _fields((2, 128, 512), 3, seed=76))
    ref = pallas_advection_pair(*(jnp.asarray(a) for a in (f, ux, uy)), DY, DX,
                                getattr(jsch, name), interpret=True)
    got = pair.advection_pair(*map(torch.from_numpy, (f, ux, uy)), DY, DX, K13_SCHEMES[name])
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 1e-5


if __name__ == "__main__":
    # each case's float32 error, relative to max|ref| (gate 1e-5)
    for name, scheme in K9_SCHEMES.items():
        for shape in K9_SHAPES:
            (f,) = _fields(shape, 1, seed=shape[-1] + len(name))
            ref = adv_lap.lap_rhs_ref(torch.from_numpy(f), DZ, DY, DX, scheme).numpy()
            print(f"K9 {name} {shape}: {_rel(k9_chained(f, DZ, DY, scheme, np.float32), ref):.3e}")
    for name, scheme in K13_SCHEMES.items():
        for shape in K13_SHAPES:
            f, ux, uy = _fields(shape, 3, seed=shape[-1] + 2 * len(name))
            ref = pair.advection_pair_ref(*map(torch.from_numpy, (f, ux, uy)), DY, DX,
                                          scheme).numpy()
            err = _rel(k13_chained(f, ux, uy, DY, scheme, np.float32), ref)
            print(f"K13 {name} {shape}: {err:.3e}")
