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

The y phase (``xy_y_kernel``: staged y-tile sub-block chains) is held the
same way, with both phases transcribed (``k9_staged``, ``k13_staged``):

* the block sizing of ``xy_y_launch``: C = 32 columns a block, halved while
  half of them still cover the plane's nx, then while the block would pass
  512 threads (``tiles * line_nb(ny)`` chains a column) or its shared
  memory (``lane.y_tile_bytes``) an H100's opt-in maximum; None where one
  column does not fit, where ``lane.y_tables`` raises and the five xy
  predicates that stage the tiles (``lane.y_phase_fits``) decline;
* the staging: ``tile[m * C + l]`` is row m of the block's column l, of
  ``sy`` (K13) or ``T_z sy`` (K9, ``TzRow.at``), 0 past the plane's last
  column;
* the solve: each staged column through ``_solve_chains`` on
  ``lane.chain_table(scheme, ny, line_nb(ny))``, its RHS rows at the y
  spacing;
* the epilogue: each thread keeps its column and walks the rows, ``out =
  my * tile`` (K13) or ``out = tile + B_z bz`` (K9, ``BzRow.at``'s
  difference form), each valid element once.

Against the same plain versions at the same gates, at y-lines of 512 (16
chains of 32 rows), 256, 257 (one chain), 6 (the fewest rows the schemes
take) and 4096 (128 chains: 4 columns a block, 2 for a pair, which moves
one column a thread at a time), on 40 x-columns (a block of 32 and a
ragged one of 8) or 12.
"""

import functools

import numpy as np
import pytest
import torch

import cfd_tpu_torch as ct
from cfd_tpu_torch.ops import _native, adv_lap, dense, fused_step, lane, megastep, pair, vec
from test_torch_lane_chains import DX, _chains, _rhs, _solve_chains

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
STAGERS = 128  # XY_CHAIN_STAGERS and XY_Y_STAGERS
SMEM = 48 * 1024  # XY_X_SMEM: what a block stages without opting in
TZROW_BYTES = 32  # sizeof(TzRow): three floats, padding, two long longs
Y_COLS = 32  # XY_Y_COLS: the columns a y block takes where they fit
Y_MAX_THREADS = 512  # XY_Y_MAX_THREADS
SMEM_OPTIN = 232448  # an H100's cudaDevAttrMaxSharedMemoryPerBlockOptin
Y_SHAPES = [(5, 512, 40), (5, 256, 40), (5, 257, 40), (5, 6, 40), (5, 4096, 12)]


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


def _y_block(ny, nx, tiles, limit=SMEM_OPTIN):
    """``xy_y_launch``'s sizing of the staged y phase: (C, threads, shared
    bytes) for ``tiles`` tiles a column, or None where one column does not
    fit ``limit`` (the launch refuses it)."""
    nb = lane.line_nb(ny)
    C = Y_COLS
    while C > 1 and C // 2 >= nx:
        C //= 2
    while C > 1 and (tiles * nb * C > Y_MAX_THREADS or lane.y_tile_bytes(ny, nb, tiles, C) > limit):
        C //= 2
    nbytes = lane.y_tile_bytes(ny, nb, tiles, C)
    return None if nbytes > limit else (C, _threads(tiles * nb * C), nbytes)


def _bz(g, scheme, dz, dtype):
    """B_z g as ``BzRow.at`` forms it: the sum over k != W of bt[p, k]
    (g[p + k - W] - g[p]), planes wrapped, in ``dtype``."""
    btab, _ = adv_lap.z_tables(scheme, g.shape[0])
    bt = (btab / dz ** scheme.derivative_order).astype(dtype)
    W = scheme.stencil_width
    out = np.zeros_like(g)
    for k in range(2 * W + 1):
        if k != W:
            out = out + bt[:, k, None, None] * (np.roll(g, W - k, 0) - g)
    return out


def _y_walk(ny, C, threads, V):
    """Each thread's V columns from l and its rows m0, m0 + rows, ... of a
    y block, in staging and the epilogue: (m, l) of every (thread, row)
    below ny, each element of the tile in exactly one of them."""
    t = np.arange(threads)
    l, m0, rows = (t * V) % C, (t * V) // C, threads * V // C
    m = np.concatenate([m0 + rows * j for j in range(-(-ny // rows))])
    l = np.tile(l, -(-ny // rows))
    live = m < ny
    m, l = m[live], l[live]
    seen = np.zeros((ny, C), int)
    for j in range(V):
        np.add.at(seen, (m, l + j), 1)
    assert (seen == 1).all()
    return m, l


def y_phase(kind, sy, schemes, dz, dy, dtype, my=None, bz=None):
    """The staged y phase of one family (``kind`` "adv" or "rhs") or pair
    ("pair": ``schemes`` the d1 and the d2 scheme) of a launch on (nz, ny,
    nx) fields, transcribed block by block: the advection output ``my *
    Dy sy`` and/or the z-RHS output ``Dy (T_z sy) + B_z bz``, as a list.
    Each thread moves V = 4 consecutive columns at a time where C and nx
    are multiples of 4 (16-byte accesses: fields are aligned here), else
    one."""
    nz, ny, nx = sy.shape
    tiles = 2 if kind == "pair" else 1
    C, threads, _ = _y_block(ny, nx, tiles)
    V = 4 if C % 4 == 0 and nx % 4 == 0 else 1
    nb = lane.line_nb(ny)
    sy = sy.astype(dtype)
    # what each tile stages (a pair: both from one read of sy)
    staged = [sy] if kind == "adv" else [sy, _tz(sy, schemes[-1], dtype)][2 - tiles:]
    bzs = None if kind == "adv" else _bz(bz.astype(dtype), schemes[-1], dz, dtype)
    my = None if my is None else my.astype(dtype)
    outs = [np.full(sy.shape, np.nan, dtype) for _ in range(tiles)]
    groups = -(-nx // C)
    wm, wl = _y_walk(ny, C, threads, V)
    for block in range(nz * groups):
        p, x0 = block // groups, (block % groups) * C
        valid = min(C, nx - x0)
        assert valid % V == 0
        tile = np.full(tiles * ny * C, np.nan, dtype)
        for j in range(V):  # tile[m C + l]: row m of column l, 0 past nx
            m, l = wm, wl + j
            for s, src in enumerate(staged):
                tile[s * ny * C + m * C + l] = np.where(
                    wl < valid, src[p, m, np.minimum(x0 + l, nx - 1)], 0)
        assert not np.isnan(tile).any()
        for s, scheme in enumerate(schemes):  # each column a y-line
            lines = tile[s * ny * C:(s + 1) * ny * C].reshape(ny, C).T
            x = _solve_chains(_rhs(lines, scheme, dtype, dy), scheme, dtype, nb)
            tile[s * ny * C:(s + 1) * ny * C] = x.T.ravel()
        live = wl < valid  # the epilogue: a thread's V columns are all valid or none
        for j in range(V):
            m, l = wm[live], wl[live] + j
            at, g = m * C + l, (p, m, x0 + l)
            if kind != "rhs":
                outs[0][g] = my[g] * tile[at]
            if kind != "adv":
                outs[-1][g] = tile[(tiles - 1) * ny * C + at] + bzs[g]
    for out in outs:
        assert not np.isnan(out).any()
    return outs


def k9_staged(f, dz, dy, scheme, dtype):
    """K9 with both phases transcribed: the staged y phase, B_z f + D2y
    (T_z f); then the chained x phase on T_z f."""
    (out,) = y_phase("rhs", f, (scheme,), dz, dy, dtype, bz=f)
    _x_phase(_tz(f.astype(dtype), scheme, dtype).reshape(-1, f.shape[-1]), out, None, scheme,
             dtype)
    return out


def k13_staged(f, ux, uy, dy, scheme, dtype):
    """K13 with both phases transcribed: the staged y phase, uy D1y f; then
    the chained x phase on f, times ux."""
    (out,) = y_phase("adv", f, (scheme,), None, dy, dtype, my=uy)
    _x_phase(f.astype(dtype).reshape(-1, f.shape[-1]), out, ux.astype(dtype), scheme, dtype)
    return out


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


def test_y_block_sizing():
    # (ny, nx, tiles) -> (C, threads, bytes): tiles * line_nb(ny) * C chains,
    # at most 1024 threads, the tiles within the opt-in maximum
    want = {(512, 512, 2): (16, 512, 69632), (512, 512, 1): (32, 512, 69632),
            (256, 256, 2): (32, 512, 69632), (256, 256, 1): (32, 256, 34816),
            (128, 8192, 1): (32, 128, 17408), (257, 40, 2): (32, 128, 66304),
            (6, 40, 2): (32, 128, 2048), (4096, 12, 2): (2, 512, 69632),
            (4096, 12, 1): (4, 512, 69632), (512, 7, 1): (8, 128, 17408),
            (29033, 8, 2): (1, 130, 232280), (29059, 8, 1): (1, 129, 116244)}
    for (ny, nx, tiles), block in want.items():
        assert _y_block(ny, nx, tiles) == block, (ny, nx, tiles)
    assert _y_block(512, 512, 2)[2] > SMEM  # opted in at 512^3 and 256^3
    assert _y_block(29059, 8, 2) is None  # a pair of one column's tiles does not fit


def test_y_tables_walk_only_where_a_column_does_not_fit(monkeypatch):
    """``lane.y_tables`` takes the staged chains (``line_nb(ny)`` sub-blocks,
    the chain tables) wherever one column's tiles fit the device's opt-in
    maximum, here an H100's (``SMEM_OPTIN`` stands in for the device
    query), and raises past it: a pair on prime y-lines of 29,059 points.
    No y phase walks columns. Off the card no limit holds."""
    pair_schemes = (ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC)
    cpu = torch.device("cpu")
    assert lane.y_tables(pair_schemes, 29059, DY, cpu)[0] == 1
    monkeypatch.setattr(_native, "smem_limit", lambda device: SMEM_OPTIN)
    for ny, tiles, nb in ((512, 2, 16), (512, 1, 16), (256, 2, 8), (29033, 2, 1),
                          (29059, 2, 0), (29059, 1, 1)):
        fits = _y_block(ny, 8, tiles) is not None
        assert lane.y_phase_fits(ny, tiles, cpu) == fits == (nb > 0), (ny, tiles)
        if not fits:
            with pytest.raises(ValueError, match=f"{ny} points in {tiles} tiles takes "
                               f"{lane.y_tile_bytes(ny, 1, tiles)} bytes.*{SMEM_OPTIN}"):
                lane.y_tables(pair_schemes[:tiles], ny, DY, cpu)
            continue
        got, tables = lane.y_tables(pair_schemes[:tiles], ny, DY, cpu)
        assert got == nb, (ny, tiles)
        for (coef, table, h, win), scheme in zip(tables, pair_schemes):
            assert coef.n == ny and coef.scale == pytest.approx(DY ** -scheme.derivative_order)
            want, wh, wwin = lane.chain_table(scheme, ny, nb)
            assert np.array_equal(table.numpy(), want.astype(np.float32))
            assert (h, win) == (wh, wwin)


# the five predicates of the xy kernels that stage y-tiles, with their
# schemes: kernel -> (predicate of ((nz, ny, nx), device), tiles a column)
Y_PREDICATES = {
    "K3": (lambda shape, dev: adv_lap.adv_lap_fits(shape, dev), 2),
    "K5": (lambda shape, dev: adv_lap.adv_lap3_fits(shape, dev), 2),
    "K6": (lambda shape, dev: vec.div_fused_supported(ct.SCHEME4_PERIODIC, *shape,
                                                      torch.float32, dev), 1),
    "K9": (lambda shape, dev: adv_lap.lap_rhs_supported(ct.SCHEME4_D2_PERIODIC, *shape,
                                                        torch.float32, dev), 1),
    "K13": (lambda shape, dev: pair.adv_pair_supported(ct.SCHEME4_PERIODIC, *shape[1:],
                                                       torch.float32, dev), 1),
}


@pytest.mark.parametrize("kernel", list(Y_PREDICATES))
def test_xy_predicates_decline_y_lines_past_the_shared_memory(monkeypatch, kernel):
    """Under an H100's opt-in maximum (``_native.smem_limit``, the one
    device query K4's ``rk3_mega_supported`` asks too), at prime y-lines of
    29,059 points a pair's two tiles of one column (232,488 bytes) do not
    fit, so K3 and K5 decline, and one tile (116,244) does, so K6, K9 and
    K13 take them; at 29,033 points every one takes them, and off the card
    no limit holds. Each predicate asks the limit of the device it is
    given."""
    predicate, tiles = Y_PREDICATES[kernel]
    cpu = torch.device("cpu")
    assert predicate((5, 29059, 8), cpu) and predicate((5, 29059, 8), None)
    asked = []
    monkeypatch.setattr(_native, "smem_limit",
                        lambda device: asked.append(device) or SMEM_OPTIN)
    assert predicate((5, 29059, 8), cpu) == (tiles == 1)
    assert asked[-1] == cpu
    assert predicate((5, 29033, 8), cpu)
    assert megastep.rk3_mega_supported(ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC,
                                       (29033, 1, 4), torch.float32, cpu)
    assert not megastep.rk3_mega_supported(ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC,
                                           (29059, 1, 4), torch.float32, cpu)


def test_fused_substeps_follow_the_y_phase_limit(monkeypatch):
    """Under an H100's opt-in maximum, on prime y-lines of 29,059 points the
    scalar substep's head is K13 + K9 (K3's pair of tiles does not fit) and
    the velocity stage declines (K5 does not fit); on y-lines of 58,111
    points, where one tile passes the limit too, the scalar substep returns
    None and the model runs its generic form. Only the routes run: the
    fields are empty."""
    s1, s2 = ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC
    monkeypatch.setattr(_native, "smem_limit", lambda device: SMEM_OPTIN)
    f = torch.empty((5, 29059, 8))
    assert fused_step.head_route(f, s1, s2) is fused_step.stepwise_head
    assert fused_step.make_fused_substep_vec(0.1, s1, s2)((f, f, f), None, 1e-3, 1e-2,
                                                          0.0, 1 / 3) is None
    f = torch.empty((5, 58111, 8))
    assert not lane.y_phase_fits(58111, 1, f.device)
    assert fused_step.head_route(f, s1, s2) is None
    assert fused_step.make_fused_substep(0.1, s1, s2)(f, (f, f, f), None, 1e-3, 1e-2,
                                                      0.0, 1 / 3) is None


@pytest.mark.parametrize("shape", Y_SHAPES, ids=[f"{s}" for s in Y_SHAPES])
@pytest.mark.parametrize("name", K9_SCHEMES)
def test_lap_rhs_staged_y_phase(name, shape):
    scheme = K9_SCHEMES[name]
    (f,) = _fields(shape, 1, seed=shape[1] + len(name))
    ref = adv_lap.lap_rhs_ref(torch.from_numpy(f), DZ, DY, DX, scheme).numpy()
    assert _rel(k9_staged(f, DZ, DY, scheme, np.float64), ref) <= F64_TOL
    assert _rel(k9_staged(f, DZ, DY, scheme, np.float32), ref) <= F32_GATE


@pytest.mark.parametrize("shape", Y_SHAPES, ids=[f"{s}" for s in Y_SHAPES])
@pytest.mark.parametrize("name", K13_SCHEMES)
def test_advection_pair_staged_y_phase(name, shape):
    scheme = K13_SCHEMES[name]
    f, ux, uy = _fields(shape, 3, seed=shape[1] + 2 * len(name))
    ref = pair.advection_pair_ref(*map(torch.from_numpy, (f, ux, uy)), DY, DX, scheme).numpy()
    assert _rel(k13_staged(f, ux, uy, DY, scheme, np.float64), ref) <= F64_TOL
    assert _rel(k13_staged(f, ux, uy, DY, scheme, np.float32), ref) <= F32_GATE


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
    for name, scheme in K9_SCHEMES.items():
        for shape in Y_SHAPES:
            (f,) = _fields(shape, 1, seed=shape[1] + len(name))
            ref = adv_lap.lap_rhs_ref(torch.from_numpy(f), DZ, DY, DX, scheme).numpy()
            print(f"K9 staged y {name} {shape}: "
                  f"{_rel(k9_staged(f, DZ, DY, scheme, np.float32), ref):.3e}")
    for name, scheme in K13_SCHEMES.items():
        for shape in Y_SHAPES:
            f, ux, uy = _fields(shape, 3, seed=shape[1] + 2 * len(name))
            ref = pair.advection_pair_ref(*map(torch.from_numpy, (f, ux, uy)), DY, DX,
                                          scheme).numpy()
            err = _rel(k13_staged(f, ux, uy, DY, scheme, np.float32), ref)
            print(f"K13 staged y {name} {shape}: {err:.3e}")
