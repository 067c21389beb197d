"""K6 (``div_rhs``), K5 (``adv_lap_rhs3``) and K3 (``adv_lap_rhs``) with
their x phase in K1's sub-block chains (``csrc/xy_phase.cuh``
``xy_chain_launch``: K6 as K9's z-RHS kind, K5 and K3 as the paired kind),
held on the CPU; and the routing of ``derivatives.divergence`` by
``vec.div_fused_supported``.

A CUDA kernel cannot run here, so the chained x phases are held through a
float64/float32 numpy transcription of what a launch does, on
``tests/test_torch_xy_chains.py``'s pieces (``walk_chains``' index map,
``TzRow``'s T_z, ``_chains``' transcription of ``solve_line_chain``), over
the y phase of the plain version:

* K6: K9's launch with a periodic d1 scheme (SCHEME4_PERIODIC,
  SCHEME6_PERIODIC): T_z ux staged into the chain layout, solved, added
  into r; against ``vec.div_rhs_ref``.
* K5: the paired launch. Block sizing with two tiles (L lines of 2 L nb
  chains, fewer until the tile, its faces and the lines' T_z rows fit 48
  KB, at least one), one walk that stages each element of u_i once into
  both halves of the tile (u_i for the advection family, T_z u_i for the
  Laplacian's), the first half's chains solved on the d1 scheme's chain
  table and the second half's on the periodic d2 scheme's, and the two
  epilogues, ``axy_i += u0 * tile`` and ``r_i += tile``; against
  ``adv_lap.adv_lap_rhs3_ref``, for ``chip_smoke.FUSED_PAIRS`` and for
  SCHEME4 (closure rows) with SCHEME4_D2_PERIODIC. The kernel runs both
  families at the wider stencil of the two; the narrower scheme's weights
  past its own are 0, so its rows are the sums transcribed here.
* K3: the same paired launch for one field f advected by (ux, uy) (K5 is
  it for each component, advected by u0 and u1); against
  ``adv_lap.adv_lap_rhs_ref``, for the same pairs.

With the y phase transcribed too (``tests/test_torch_xy_chains.py``'s
``y_phase``: the staged y-tile sub-block chains of ``xy_y_kernel``): K6
stages T_z uy in one tile and writes ``tile + B_z uz``; K5 and K3 stage,
from one read of each element of u_i (f), u_i into the first tile and T_z
u_i into the second (two tiles: half the columns a block of one tile where
the threads or the shared memory bind), solve the first on the d1
scheme's y chain table and the second on the d2 scheme's, and write ``u1
* tile`` (``uy * tile``) and ``tile + B_z u_i``; at y-lines of 512, 256,
257, 6 and 4096 (2 columns a block for a pair).

Gates: 1e-10 of max|ref| in float64, within 1e-5 in float32 (each output
against its own max|ref|). K6 at x-lines of 8192, 512, 256, 257 (one
chain) and 12278 (opted-in shared memory), K5 at 256, 512, 257 and 6134
(two chains of 3067 rows, opted in), K3 at 256, 257 and 6134; the fewest
planes and y-lines the schemes take (nz >= 5 for the sixth-order z
stencils, ny >= 6). Past 1024 points the float64 plain versions take their
x derivative from the banded solve (``dense.dense_derivative``). The plain
versions are held against the Pallas kernels in interpret mode by
``tests/test_torch_navier_stokes.py``.
"""

import numpy as np
import pytest
import torch

import cfd_tpu_torch as ct
from cfd_tpu_torch.ops import _native, adv_lap, dense, lane, vec
from test_torch_lane_chains import DX, _chains
from test_torch_xy_chains import (
    CHAIN_THREADS, F32_GATE, F64_TOL, SMEM, SMEM_OPTIN, TZROW_BYTES, Y_SHAPES, _check_walk, _fields,
    _rel, _threads, _tz, _x_phase, y_phase,
)

DZ, DY = 0.07, 0.03
K6_SCHEMES = {"SCHEME4_PERIODIC": ct.SCHEME4_PERIODIC, "SCHEME6_PERIODIC": ct.SCHEME6_PERIODIC}
K6_SHAPES = [(5, 8, 8192), (5, 8, 512), (5, 8, 256), (5, 8, 257), (5, 8, 12278)]
K5_PAIRS = {  # chip_smoke.FUSED_PAIRS, and a d1 scheme with closure rows
    "SCHEME4_PERIODIC+SCHEME4_D2_PERIODIC": (ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC),
    "SCHEME6_PERIODIC+SCHEME6_D2_PERIODIC": (ct.SCHEME6_PERIODIC, ct.SCHEME6_D2_PERIODIC),
    "SCHEME4+SCHEME4_D2_PERIODIC": (ct.SCHEME4, ct.SCHEME4_D2_PERIODIC),
}
K5_SHAPES = [(5, 8, 256), (5, 8, 512), (5, 8, 257), (5, 8, 6134)]
K3_SHAPES = [(5, 8, 256), (5, 8, 257), (5, 8, 6134)]


def k6_chained(ux, uy, uz, dz, dy, scheme, dtype):
    """K6 with its x phase transcribed (x spacing DX): the y phase, B_z uz +
    D1y (T_z uy), from the plain version; then K9's chained x phase on T_z
    ux."""
    ux, uy, uz = (a.astype(dtype) for a in (ux, uy, uz))
    y = (dense.dense_apply("rhs", torch.from_numpy(uz), scheme, 0, float(dz))
         + dense.dense_derivative(dense.dense_apply("lhs", torch.from_numpy(uy), scheme, 0),
                                  dy, scheme, -2))
    out = y.numpy().copy()
    _x_phase(_tz(ux, scheme, dtype).reshape(-1, ux.shape[-1]), out, None, scheme, dtype)
    return out


def _pair_lines_per_block(n, nb):
    """``xy_chain_launch<XY_PAIR>``'s L: XY_CHAIN_THREADS / (2 nb) lines,
    fewer until ``xy_chain_bytes`` (the lines' T_z rows, the tile of 2 L
    lines and their faces) fits 48 KB, at least one."""
    def nbytes(L):
        return TZROW_BYTES * L + 4 * ((n // nb) * ((2 * L * nb) | 1) + 2 * L * 2 * nb)
    L = CHAIN_THREADS // (2 * nb)
    while L > 1 and nbytes(L) > SMEM:
        L -= 1
    return L, nbytes(L)


def _pair_x_phase(sx, tsx, out_a, out_r, mx, s1, s2, dtype):
    """The paired chained x phase of one component: stage each element of
    ``sx`` (lines (lines, n)) once into both halves of a block's tile, sx
    for the advection family and ``tsx`` (T_z sx) for the Laplacian's;
    solve the first half on ``s1``'s chains and the second on ``s2``'s; add
    ``mx`` times the first into ``out_a`` and the second into ``out_r``."""
    lines, n = sx.shape
    nb = lane.line_nb(n)
    bz = n // nb
    L, _ = _pair_lines_per_block(n, nb)
    half = L * nb
    cs = (2 * half) | 1
    blocks = []
    for line0 in range(0, lines, L):
        nl = min(L, lines - line0)
        e, at, l = _check_walk(nl * n, n, nb, L, 2)
        tile = np.full(bz * cs, np.nan, dtype)
        v = sx[line0:line0 + nl].ravel()[e]  # one read of each element
        tile[at] = v
        tile[at + half] = tsx[line0:line0 + nl].ravel()[e]
        blocks.append((line0, nl, e, at, tile))

    def lines_of(t, nl, first):  # a family's staged lines, (nl, n)
        return (t.reshape(bz, cs)[:, first:first + nl * nb].reshape(bz, nl, nb)
                .transpose(1, 2, 0).reshape(nl, n))

    solved = [_chains(np.concatenate([lines_of(t, nl, first) for _, nl, _, _, t in blocks]),
                      scheme, dtype) for first, scheme in ((0, s1), (half, s2))]
    row = 0
    for line0, nl, e, at, tile in blocks:
        t = tile.reshape(bz, cs)
        for first, x in zip((0, half), solved):
            t[:, first:first + nl * nb] = x[row:row + nl].reshape(nl, nb, bz).transpose(
                2, 0, 1).reshape(bz, nl * nb)
        row += nl
        g = line0 * n + e
        out_a.reshape(-1)[g] += mx.reshape(-1)[g] * tile[at]
        out_r.reshape(-1)[g] += tile[at + half]


def k3_chained(f, ux, uy, dz, dy, s1, s2, dtype):
    """K3 with its x phase transcribed (x spacing DX): the y phase, uy D1y f
    and B_z f + D2y (T_z f), from the plain version; then the paired
    chained x phase on f and T_z f, advected by ux."""
    f, ux, uy = (a.astype(dtype) for a in (f, ux, uy))
    t = torch.from_numpy(f)
    a = (torch.from_numpy(uy) * dense.dense_derivative(t, dy, s1, -2)).numpy().copy()
    r = (dense.dense_apply("rhs", t, s2, 0, float(dz) ** 2)
         + dense.dense_derivative(dense.dense_apply("lhs", t, s2, 0), dy, s2, -2))
    r = r.numpy().copy()
    n = f.shape[-1]
    _pair_x_phase(f.reshape(-1, n), _tz(f, s2, dtype).reshape(-1, n), a, r, ux, s1, s2, dtype)
    return a, r


def k5_chained(u, dz, dy, s1, s2, dtype):
    """K5 with its x phase transcribed: K3's launch on each component u_i,
    advected by u0 and u1 (the kernel runs the same pair of families for
    each component, one grid row a component)."""
    outs = [k3_chained(c, u[0], u[1], dz, dy, s1, s2, dtype) for c in u]
    return [o[0] for o in outs], [o[1] for o in outs]


def k6_staged(ux, uy, uz, dz, dy, scheme, dtype):
    """K6 with both phases transcribed: the staged y phase, B_z uz + D1y
    (T_z uy); then K9's chained x phase on T_z ux."""
    (out,) = y_phase("rhs", uy, (scheme,), dz, dy, dtype, bz=uz)
    _x_phase(_tz(ux.astype(dtype), scheme, dtype).reshape(-1, ux.shape[-1]), out, None, scheme,
             dtype)
    return out


def k3_staged(f, ux, uy, dz, dy, s1, s2, dtype):
    """K3 with both phases transcribed: the staged paired y phase, uy D1y f
    and B_z f + D2y (T_z f) from one read of f; then the paired chained x
    phase on f and T_z f, advected by ux."""
    a, r = y_phase("pair", f, (s1, s2), dz, dy, dtype, my=uy, bz=f)
    n = f.shape[-1]
    f = f.astype(dtype)
    _pair_x_phase(f.reshape(-1, n), _tz(f, s2, dtype).reshape(-1, n), a, r, ux.astype(dtype), s1,
                  s2, dtype)
    return a, r


def k5_staged(u, dz, dy, s1, s2, dtype):
    """K5 with both phases transcribed: K3's launch on each component u_i,
    advected by u0 and u1 (one grid row a component in both phases)."""
    outs = [k3_staged(c, u[0], u[1], dz, dy, s1, s2, dtype) for c in u]
    return [o[0] for o in outs], [o[1] for o in outs]


def test_pair_lines_per_block():
    # (n) -> (nb, L, threads, shared bytes): 2 L nb chains, at most 256
    want = {256: (8, 16, 256), 512: (16, 8, 256), 257: (1, 22, 140), 6134: (2, 1, 132)}
    for n, (nb, L, threads) in want.items():
        assert lane.line_nb(n) == nb
        got, nbytes = _pair_lines_per_block(n, nb)
        assert (got, _threads(2 * got * nb)) == (L, threads)
        assert (nbytes > SMEM) == (n == 6134)  # one line of two tiles opts in
    assert _pair_lines_per_block(256, 8)[1] == 35456  # 35 KB at 256^3


@pytest.mark.parametrize("shape", K6_SHAPES, ids=[f"{s}" for s in K6_SHAPES])
@pytest.mark.parametrize("name", K6_SCHEMES)
def test_div_rhs_chained_x_phase(name, shape):
    scheme = K6_SCHEMES[name]
    ux, uy, uz = _fields(shape, 3, seed=shape[-1] + 3 * len(name))
    ref = vec.div_rhs_ref(*map(torch.from_numpy, (ux, uy, uz)), DZ, DY, DX, scheme).numpy()
    assert _rel(k6_chained(ux, uy, uz, DZ, DY, scheme, np.float64), ref) <= F64_TOL
    assert _rel(k6_chained(ux, uy, uz, DZ, DY, scheme, np.float32), ref) <= F32_GATE


@pytest.mark.parametrize("shape", K5_SHAPES, ids=[f"{s}" for s in K5_SHAPES])
@pytest.mark.parametrize("name", K5_PAIRS)
def test_adv_lap_rhs3_paired_chained_x_phase(name, shape):
    s1, s2 = K5_PAIRS[name]
    u = _fields(shape, 3, seed=shape[-1] + 5 * len(name))
    refs = adv_lap.adv_lap_rhs3_ref(tuple(map(torch.from_numpy, u)), DZ, DY, DX, s1, s2)
    for dtype, gate in ((np.float64, F64_TOL), (np.float32, F32_GATE)):
        axy, r = k5_chained(u, DZ, DY, s1, s2, dtype)
        for got, ref in zip(axy + r, refs[0] + refs[1]):
            assert _rel(got, ref.numpy()) <= gate


@pytest.mark.parametrize("shape", K3_SHAPES, ids=[f"{s}" for s in K3_SHAPES])
@pytest.mark.parametrize("name", K5_PAIRS)
def test_adv_lap_rhs_paired_chained_x_phase(name, shape):
    s1, s2 = K5_PAIRS[name]
    f, ux, uy = _fields(shape, 3, seed=shape[-1] + 11 * len(name))
    ref = adv_lap.adv_lap_rhs_ref(*map(torch.from_numpy, (f, ux, uy)), DZ, DY, DX, s1, s2)
    for dtype, gate in ((np.float64, F64_TOL), (np.float32, F32_GATE)):
        for got, want in zip(k3_chained(f, ux, uy, DZ, DY, s1, s2, dtype), ref):
            assert _rel(got, want.numpy()) <= gate


@pytest.mark.parametrize("shape", Y_SHAPES, ids=[f"{s}" for s in Y_SHAPES])
@pytest.mark.parametrize("name", K6_SCHEMES)
def test_div_rhs_staged_y_phase(name, shape):
    scheme = K6_SCHEMES[name]
    ux, uy, uz = _fields(shape, 3, seed=shape[1] + 3 * len(name))
    ref = vec.div_rhs_ref(*map(torch.from_numpy, (ux, uy, uz)), DZ, DY, DX, scheme).numpy()
    assert _rel(k6_staged(ux, uy, uz, DZ, DY, scheme, np.float64), ref) <= F64_TOL
    assert _rel(k6_staged(ux, uy, uz, DZ, DY, scheme, np.float32), ref) <= F32_GATE


@pytest.mark.parametrize("shape", Y_SHAPES, ids=[f"{s}" for s in Y_SHAPES])
@pytest.mark.parametrize("name", K5_PAIRS)
def test_adv_lap_rhs3_staged_paired_y_phase(name, shape):
    s1, s2 = K5_PAIRS[name]
    u = _fields(shape, 3, seed=shape[1] + 5 * len(name))
    refs = adv_lap.adv_lap_rhs3_ref(tuple(map(torch.from_numpy, u)), DZ, DY, DX, s1, s2)
    for dtype, gate in ((np.float64, F64_TOL), (np.float32, F32_GATE)):
        axy, r = k5_staged(u, DZ, DY, s1, s2, dtype)
        for got, ref in zip(axy + r, refs[0] + refs[1]):
            assert _rel(got, ref.numpy()) <= gate


@pytest.mark.parametrize("shape", Y_SHAPES, ids=[f"{s}" for s in Y_SHAPES])
@pytest.mark.parametrize("name", K5_PAIRS)
def test_adv_lap_rhs_staged_paired_y_phase(name, shape):
    s1, s2 = K5_PAIRS[name]
    f, ux, uy = _fields(shape, 3, seed=shape[1] + 11 * len(name))
    ref = adv_lap.adv_lap_rhs_ref(*map(torch.from_numpy, (f, ux, uy)), DZ, DY, DX, s1, s2)
    for dtype, gate in ((np.float64, F64_TOL), (np.float32, F32_GATE)):
        for got, want in zip(k3_staged(f, ux, uy, DZ, DY, s1, s2, dtype), ref):
            assert _rel(got, want.numpy()) <= gate


def test_div_fused_supported_follows_the_jax_predicate():
    """The conditions that carry over from ``cfd_tpu.ops.pallas_vec``:
    scheme, dtype and nz (its ``div_rhs_supported``, and its
    ``div_fused_supported`` where K2 solves nz on the TPU too) on planes
    both take; then the card's x-line limit in place of the VMEM slabs."""
    jnp = pytest.importorskip("jax.numpy")
    import cfd_tpu.schemes as jsch
    from cfd_tpu.ops import pallas_vec

    names = ("SCHEME4", "SCHEME4_PERIODIC", "SCHEME6", "SCHEME6_PERIODIC",
             "SCHEME4_D2_PERIODIC", "SCHEME6_D2_PERIODIC")
    for name in names:
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
            # even nz: the TPU's slabs (a divisor of nz of at least W planes),
            # which the card does not need, divide them all
            for nz in (2, 4, 6, 8, 64, 256):
                got = vec.div_fused_supported(getattr(ct, name), nz, 128, 128, tdt)
                assert got == pallas_vec.div_rhs_supported(getattr(jsch, name), nz, 128, 128,
                                                           jdt), (name, tdt, nz)
                if nz >= 64:  # K2's z lines on the TPU: at least two sub-blocks of 32
                    assert got == pallas_vec.div_fused_supported(getattr(jsch, name), nz, 128,
                                                                 128, jdt), (name, tdt, nz)
    f32 = torch.float32
    assert _native.x_lines_fit(12278) and not _native.x_lines_fit(12279)
    assert vec.div_fused_supported(ct.SCHEME4_PERIODIC, 8, 8, 12278, f32)
    assert not vec.div_fused_supported(ct.SCHEME4_PERIODIC, 8, 8, 12279, f32)
    assert not vec.div_fused_supported(ct.SCHEME4_PERIODIC, 8, 8, 12290, f32)


def test_divergence_past_the_x_limit_is_the_three_derivative_sum(monkeypatch):
    """Where ``div_fused_supported`` is False, ``divergence`` on a CUDA
    tensor routes to the three derivatives, as the JAX function does; the
    route is decided on the host before any launch, so CPU tensors dressed
    as CUDA ones show which route it takes (an H100's opt-in maximum stands
    in for the device query of the y phase's fit, ``_native.smem_limit``)."""
    calls = []
    monkeypatch.setattr(_native, "smem_limit", lambda device: SMEM_OPTIN)
    monkeypatch.setattr(vec, "divergence_fused", lambda *a, **k: calls.append("fused"))
    from cfd_tpu_torch.ops import derivatives

    for name in ("dfdx", "dfdy", "dfdz"):
        monkeypatch.setattr(derivatives, name, lambda f, *a, _n=name, **k: calls.append(_n) or 0)

    class Cuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    for nx, route in ((12290, ["dfdx", "dfdy", "dfdz"]), (256, ["fused"])):
        u = [torch.zeros((8, 8, nx)).as_subclass(Cuda) for _ in range(3)]
        calls.clear()
        ct.divergence(u, (0.1, 0.1, 0.1), ct.SCHEME4_PERIODIC)
        assert calls == route, nx


if __name__ == "__main__":
    # each case's float32 error, relative to max|ref| (gate 1e-5)
    for name, scheme in K6_SCHEMES.items():
        for shape in K6_SHAPES:
            u = _fields(shape, 3, seed=shape[-1] + 3 * len(name))
            ref = vec.div_rhs_ref(*map(torch.from_numpy, u), DZ, DY, DX, scheme).numpy()
            print(f"K6 {name} {shape}: {_rel(k6_chained(*u, DZ, DY, scheme, np.float32), ref):.3e}")
    for name, (s1, s2) in K5_PAIRS.items():
        for shape in K5_SHAPES:
            u = _fields(shape, 3, seed=shape[-1] + 5 * len(name))
            refs = adv_lap.adv_lap_rhs3_ref(tuple(map(torch.from_numpy, u)), DZ, DY, DX, s1, s2)
            axy, r = k5_chained(u, DZ, DY, s1, s2, np.float32)
            err = max(_rel(g, f.numpy()) for g, f in zip(axy + r, refs[0] + refs[1]))
            print(f"K5 {name} {shape}: {err:.3e}")
    for name, scheme in K6_SCHEMES.items():
        for shape in Y_SHAPES:
            u = _fields(shape, 3, seed=shape[1] + 3 * len(name))
            ref = vec.div_rhs_ref(*map(torch.from_numpy, u), DZ, DY, DX, scheme).numpy()
            print(f"K6 staged y {name} {shape}: "
                  f"{_rel(k6_staged(*u, DZ, DY, scheme, np.float32), ref):.3e}")
    for name, (s1, s2) in K5_PAIRS.items():
        for shape in Y_SHAPES:
            u = _fields(shape, 3, seed=shape[1] + 5 * len(name))
            refs = adv_lap.adv_lap_rhs3_ref(tuple(map(torch.from_numpy, u)), DZ, DY, DX, s1, s2)
            axy, r = k5_staged(u, DZ, DY, s1, s2, np.float32)
            err = max(_rel(g, f.numpy()) for g, f in zip(axy + r, refs[0] + refs[1]))
            print(f"K5 staged y {name} {shape}: {err:.3e}")
