"""K4 (``rk3_mega``) as staged z-tile sub-block chains with the RK update as
their epilogue (``csrc/rk3_mega.cu``), held on the CPU; and the shared-memory
condition of ``megastep.rk3_mega_supported``.

A CUDA kernel cannot run here, so the launch is held through a
float64/float32 numpy transcription of what it does, on the (nz, cols)
view of the fields, cols = ny * nx:

* block sizing: C = 32 columns a block, halved while half of them still
  covers every column, then while the block would pass 1024 threads (2 nb
  chains a column) or its shared memory (two tiles of nz rows and 2 nb face
  slots a family and column) the device's opt-in maximum; whole warps
  before the chains where they are fewer than 128;
* staging down z: ``tile[m * C + l]`` is row m of the block's column l, of
  f in tile A and of r in tile B, by 16-byte copies of four columns where
  the rows are aligned and by 4-byte copies (zero past the last column)
  otherwise; each slot written once;
* the solves: every column of tile A through family A's chains (the d1
  scheme's RHS rows, ``tests/test_torch_lane_chains.py``'s ``_rhs``, solved
  by its ``_solve_chains`` on ``lane.chain_table(scheme1, nz, nb)``), and of
  tile B through family B's: the identity RHS (the kernel's Coef of centre
  weight 1, scale 1 and no closure rows returns r itself) solved on the d2
  scheme's chain table, with ``nb = lane.line_nb(nz)``;
* the epilogue: each thread keeps its column and walks the rows, ``q' = a q
  + dt nu lap - dt (axy + uz fz)``, ``f' = f + b q'``, in the kernel's order
  of float32 operations; each valid element once.

It must equal ``megastep.rk3_mega_ref`` (the dense operators) at 1e-10 of
max|ref| in float64 and stay within 1e-5 in float32, for SCHEME4_PERIODIC +
SCHEME4_D2_PERIODIC and SCHEME6_PERIODIC + SCHEME6_D2_PERIODIC (the fused
pairs) and SCHEME4 + SCHEME4_D2 (closure rows in both families), at nz =
256 (8 chains of 32 rows), 64 (2), 42 (one chain), 257 (prime: one chain)
and 40 (one chain; ragged), on the first substep (no q), a middle one and
the last (no q' written). The fields are (nz, 4, 10): two blocks a launch,
the first staged by 16-byte copies, the second ragged (8 columns). At dt nu
= 1 the Laplacian and the advection term both move q' by O(1).
"""

import numpy as np
import pytest
import torch

import cfd_tpu_torch as ct
from cfd_tpu_torch.ops import fused_step, lane, megastep
from test_torch_lane_chains import _rhs, _solve_chains

MEGA_COLS = 32  # columns a block takes where they fit
MAX_THREADS = 1024
STAGERS = 128
SMEM_OPTIN = 232448  # an H100's cudaDevAttrMaxSharedMemoryPerBlockOptin
F64_TOL = 1e-10
F32_GATE = 1e-5
DZ = 0.07
RK = dict(a=-5.0 / 9.0, b=15.0 / 16.0, dt=0.05, nu=20.0)  # dt * nu = 1
PAIRS = {
    "SCHEME4_PERIODIC+SCHEME4_D2_PERIODIC": (ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC),
    "SCHEME6_PERIODIC+SCHEME6_D2_PERIODIC": (ct.SCHEME6_PERIODIC, ct.SCHEME6_D2_PERIODIC),
    "SCHEME4+SCHEME4_D2": (ct.SCHEME4, ct.SCHEME4_D2),
}
NZ = [256, 64, 42, 257, 40]
SUBSTEPS = {"first": (False, True), "middle": (True, True), "last": (True, False)}  # q, write_q


def _bytes(nz, nb, C):
    """``mega_bytes``: two tiles of C columns of nz rows, and each family's
    2 nb face slots a column."""
    return 4 * C * (2 * nz + 2 * 2 * nb)


def _block(nz, nb, cols):
    """``cfd_rk3_mega``'s sizing: (C, threads, shared bytes), or None where
    one column does not fit."""
    C = MEGA_COLS
    while C > 1 and C // 2 >= cols:
        C //= 2
    while C > 1 and (2 * nb * C > MAX_THREADS or _bytes(nz, nb, C) > SMEM_OPTIN):
        C //= 2
    if _bytes(nz, nb, C) > SMEM_OPTIN:
        return None
    chains = 2 * nb * C
    lead = -(-(STAGERS - chains) // 32) * 32 if chains < STAGERS else 0
    return C, lead + chains, _bytes(nz, nb, C)


def _stage(src, j0, C, aligned):
    """One block's tile of ``src`` (nz, cols): ``tile[m * C + l]`` by the
    kernel's index arithmetic, with each slot's write count."""
    nz, cols = src.shape
    flat = src.ravel()
    valid = min(C, cols - j0)
    tile = np.full(nz * C, np.nan, src.dtype)
    writes = np.zeros(nz * C, int)
    if aligned and valid == C:
        quads = C // 4
        e = np.arange(nz * quads)
        m, c4 = e // quads, 4 * (e % quads)
        for u in range(4):
            tile[m * C + c4 + u] = flat[m * cols + j0 + c4 + u]
            np.add.at(writes, m * C + c4 + u, 1)
    else:
        e = np.arange(nz * C)
        m, l = e // C, e % C
        ok = l < valid
        tile[m * C + l] = np.where(ok, flat[m * cols + j0 + np.minimum(l, valid - 1)], 0)
        np.add.at(writes, m * C + l, 1)
    return tile, writes


def mega_chained(f, r, axy, uz, q, s1, s2, dz, dtype, *, a, b, dt, nu, write_q=True):
    """K4's launch transcribed on fields (nz, ny, nx): ``(q' or None, f')``."""
    nz = f.shape[0]
    cols = f.size // nz
    f, r, axy, uz = (x.astype(dtype).reshape(nz, cols) for x in (f, r, axy, uz))
    q = None if q is None else q.astype(dtype).reshape(nz, cols)
    nb = lane.line_nb(nz)
    C, threads, _ = _block(nz, nb, cols)
    aligned = C % 4 == 0 and cols % 4 == 0
    cast = np.dtype(dtype).type
    ka, kb, kdt, kdt_nu = (cast(v) for v in (a, b, dt, float(dt) * float(nu)))
    qout = np.full((nz, cols), np.nan, dtype) if write_q else None
    fout = np.full((nz, cols), np.nan, dtype)
    for j0 in range(0, cols, C):
        valid = min(C, cols - j0)
        (ta, wa), (tb, wb) = _stage(f, j0, C, aligned), _stage(r, j0, C, aligned)
        assert (wa == 1).all() and (wb == 1).all()
        assert not ta.reshape(nz, C)[:, valid:].any()
        # each column a z-line; family A forms the d1 rows, family B's are r
        lines_a, lines_b = ta.reshape(nz, C).T, tb.reshape(nz, C).T
        fz = _solve_chains(_rhs(lines_a, s1, dtype, dz), s1, dtype, nb).T.ravel()
        lap = _solve_chains(lines_b, s2, dtype, nb).T.ravel()
        # the epilogue: thread t keeps column t % C and walks rows t // C,
        # t // C + threads / C, ...
        assert threads % C == 0
        t = np.arange(threads)
        l = t % C
        seen = np.zeros((nz, C), int)
        for m0 in range(0, nz, threads // C):
            m = m0 + t // C
            live = (m < nz) & (l < valid)
            mm, ll = m[live], l[live]
            np.add.at(seen, (mm, ll), 1)
            e = (mm, j0 + ll)
            adv = axy[e] + uz[e] * fz[mm * C + ll]
            qn = kdt_nu * lap[mm * C + ll] - kdt * adv
            if q is not None:
                qn = qn + ka * q[e]
            if write_q:
                qout[e] = qn
            fout[e] = f[e] + kb * qn
        assert (seen[:, :valid] == 1).all() and not seen[:, valid:].any()
    shape = (nz, -1)
    return (None if qout is None else qout.reshape(shape)), fout.reshape(shape)


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64).reshape(ref.shape) - ref).max() / np.abs(ref).max()


def test_block_sizing():
    # nz -> (nb, C, threads, bytes): 2 nb C chains, at most 1024 threads,
    # the tiles within the opt-in maximum
    want = {256: (8, 32, 512, 69632), 64: (2, 32, 128, 17408), 42: (1, 32, 128, 11264),
            257: (1, 32, 128, 66304), 40: (1, 32, 128, 10752), 512: (16, 32, 1024, 139264),
            8192: (128, 2, 512, 135168)}
    for nz, (nb, C, threads, nbytes) in want.items():
        assert lane.line_nb(nz) == nb
        assert _block(nz, nb, 65536) == (C, threads, nbytes), nz
        assert megastep.tile_bytes(nz, nb, C) == nbytes
    assert _block(256, 8, 65536)[2] > 48 * 1024  # opted in at 256^3
    assert _block(64, 2, 7)[0] == 8  # few columns: fewer a block
    assert _block(29033, 1, 4)[0] == 1 and _block(29059, 1, 4) is None


@pytest.mark.parametrize("case", list(SUBSTEPS))
@pytest.mark.parametrize("nz", NZ)
@pytest.mark.parametrize("name", PAIRS)
def test_rk3_mega_chained_launch(name, nz, case):
    s1, s2 = PAIRS[name]
    has_q, write_q = SUBSTEPS[case]
    rng = np.random.default_rng(nz + 7 * len(name) + len(case))
    f, r, axy, uz, q = (rng.standard_normal((nz, 4, 10)) + 0.5 for _ in range(5))
    q = q if has_q else None
    kw = dict(RK, write_q=write_q)
    ref_q, ref_f = megastep.rk3_mega_ref(*map(torch.from_numpy, (f, r, axy, uz)),
                                         None if q is None else torch.from_numpy(q),
                                         s1, s2, DZ, **kw)
    for dtype, gate in ((np.float64, F64_TOL), (np.float32, F32_GATE)):
        got_q, got_f = mega_chained(f, r, axy, uz, q, s1, s2, DZ, dtype, **kw)
        assert _rel(got_f, ref_f.numpy()) <= gate
        if write_q:
            assert _rel(got_q, ref_q.numpy()) <= gate
        else:
            assert got_q is None and ref_q is None


def test_rk3_mega_supported_takes_what_fits_the_shared_memory(monkeypatch):
    """Two tiles of one column and its faces within the device's opt-in
    maximum, here an H100's (``SMEM_OPTIN`` stands in for the device query):
    the prime nz = 29033 (one chain, 232,280 bytes) fits, 29059 (232,488)
    does not, nor does 29039 (71 chains of 409 rows: 233,448); the fused
    substep's tail then runs stepwise, as it does where the JAX K4 declines.
    Off the card the plain version stages nothing, and no limit holds."""
    s1, s2 = PAIRS["SCHEME4_PERIODIC+SCHEME4_D2_PERIODIC"]
    f32 = torch.float32
    sizes = (256, 8192, 29033, 29039, 29059)
    for nz in sizes:
        assert megastep.smem_limit(torch.device("cpu")) is None
        assert megastep.rk3_mega_supported(s1, s2, (nz, 1, 4), f32, "cpu"), nz
        assert fused_step.tail_route(torch.zeros((nz, 1, 4)), s1, s2) is fused_step.mega_tail
    asked = []
    monkeypatch.setattr(megastep, "smem_limit", lambda device: asked.append(device) or SMEM_OPTIN)
    for nz in sizes:
        fits = megastep.tile_bytes(nz, lane.line_nb(nz)) <= SMEM_OPTIN
        assert fits == (_block(nz, lane.line_nb(nz), 4) is not None), nz
        assert megastep.rk3_mega_supported(s1, s2, (nz, 1, 4), f32, "cpu") == fits, nz
        want = fused_step.mega_tail if fits else fused_step.stepwise_tail
        assert fused_step.tail_route(torch.zeros((nz, 1, 4)), s1, s2) is want, nz
    # the route asks the limit of the field's own device
    assert asked[-1] == torch.device("cpu")
    assert [nz for nz in (29033, 29039, 29059)
            if megastep.rk3_mega_supported(s1, s2, (nz, 1, 4), f32, "cpu")] == [29033]
    # the conditions that stand beside it
    assert not megastep.rk3_mega_supported(s1, s2, (256, 256, 256), torch.float64)
    assert not megastep.rk3_mega_supported(s1, s2, (256, 256), f32)
    assert not megastep.rk3_mega_supported(ct.SCHEME6, ct.SCHEME6_D2, (4, 8, 8), f32)


if __name__ == "__main__":
    # each case's float32 error, relative to max|ref| (gate 1e-5)
    for name, (s1, s2) in PAIRS.items():
        for nz in NZ:
            rng = np.random.default_rng(nz)
            f, r, axy, uz, q = (rng.standard_normal((nz, 4, 10)) + 0.5 for _ in range(5))
            ref_q, ref_f = megastep.rk3_mega_ref(*map(torch.from_numpy, (f, r, axy, uz, q)),
                                                 s1, s2, DZ, **RK)
            got_q, got_f = mega_chained(f, r, axy, uz, q, s1, s2, DZ, np.float32, **RK)
            print(f"{name} nz={nz}: f' {_rel(got_f, ref_f.numpy()):.3e} "
                  f"q' {_rel(got_q, ref_q.numpy()):.3e}")
