"""The shard-local kernels K11 and K12 (``ops/dist.py``): their plain
versions against the JAX package's dist kernels, and the kernels against
their plain versions on the card.

Inputs are made by numpy from a seed: a shard block ``f``, its halo rows
(random on a side with a neighbour, the closure ghost rows on a
non-periodic line's physical end, as the distributed solve feeds them) and
interface weights ``ab``, for a first, an interior and a last shard of a
line over three shards.

* float64 plain versions (``lane_dist_derivative_ref``,
  ``sublane_dist_derivative_ref``, ``leading_dist_derivative_ref``,
  ``solve_lines_tables_ref``) against ``cfd_tpu``'s
  ``lane_dist_derivative``, ``sublane_dist_derivative``,
  ``leading_dist_derivative`` and ``solve_lines_tables_pallas`` in
  interpret mode on the same float32 inputs: relative to max|ref|, at the
  gates the JAX dist kernels meet against float64
  (``tests/test_dist_kernels.py``): 2e-6 first derivatives and periodic
  second derivatives, 2e-5 second derivatives with closures, 5e-6
  periodic filters, 1e-4 filters with closures;
* the ghost rows of ``ops/rhs.closure_ghosts`` against ``cfd_tpu``'s
  (1e-12) and the plain versions' closure rows against the ghost form
  (1e-12, float64);
* the TF32 guard of the distributed dots;
* on the card (``gpu`` marker; skipped without one): K11 and K12 (with
  and without ``ab``) against their plain versions in float64 on the same
  float32 inputs, at the same gates, with one launch counted each, on
  shard lines of nl in {40, 64, 96, 128, 256}: one to eight sub-blocks
  (``parallel.dist_tables.pick_nb``), 40 no multiple of 32.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import cfd_tpu_torch.schemes as tsch
from cfd_tpu_torch.ops import dist
from cfd_tpu_torch.ops.rhs import closure_ghosts, compact_rhs, stencil_rhs
from cfd_tpu_torch.parallel import DistributedCompactSolver, Grid, make_mesh
from cfd_tpu_torch.parallel.dist_tables import shard_blocks

GATES = {
    "SCHEME4": 2e-6, "SCHEME4_PERIODIC": 2e-6, "SCHEME4_D2": 2e-5,
    "SCHEME4_D2_PERIODIC": 2e-6, "filter6": 1e-4, "filter6_periodic": 5e-6,
}
NAMES = list(GATES)
P = 3
SHARDS = {"first": 0, "interior": 1, "last": 2}
DX = 0.05


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules. Imported here, not at the top, so that the
    card's tests run where JAX is not installed (``--noconftest``)."""
    pytest.importorskip("jax")
    names = {"jax": "jax", "jnp": "jax.numpy", "jdist": "cfd_tpu.ops.pallas_dist",
             "jcompact": "cfd_tpu.parallel.compact", "jdt": "cfd_tpu.parallel.dist_tables",
             "jsch": "cfd_tpu.schemes", "jfused": "cfd_tpu.ops.pallas_fused",
             "jleading": "cfd_tpu.ops.pallas_leading", "jrhs": "cfd_tpu.ops.rhs"}
    return types.SimpleNamespace(**{k: importlib.import_module(m) for k, m in names.items()})


def _scheme(name):
    if name.startswith("filter6"):
        return tsch.get_filter(6, periodic=name.endswith("periodic"))
    return getattr(tsch, name)


def _pair(jx, name):
    """(cfd_tpu scheme, port scheme)"""
    if name.startswith("filter6"):
        return jx.jsch.get_filter(6, periodic=name.endswith("periodic")), _scheme(name)
    return getattr(jx.jsch, name), _scheme(name)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _inputs(scheme, r, shape, axis, seed):
    """float32 numpy (f, hl, hr, ab) of shard r with the line along ``axis``:
    halos random where a neighbour is, closure ghosts on a physical end."""
    rng = np.random.default_rng(seed)
    w = scheme.stencil_width
    with_rows = lambda rows: shape[:axis] + (rows,) + shape[axis + 1 :]
    f = rng.standard_normal(shape).astype(np.float32)
    hl = rng.standard_normal(with_rows(w)).astype(np.float32)
    hr = rng.standard_normal(with_rows(w)).astype(np.float32)
    ab = rng.standard_normal(with_rows(2)).astype(np.float32)
    if not scheme.periodic:
        gl, gr = closure_ghosts(torch.from_numpy(f).double().movedim(axis, 0), scheme)
        ghost = lambda g: np.ascontiguousarray(g.movedim(0, axis).float().numpy())
        if r == 0:
            hl = ghost(gl)
        if r == P - 1:
            hr = ghost(gr)
    return f, hl, hr, ab


def _t64(*arrays):
    return tuple(torch.from_numpy(a).double() for a in arrays)


def _shard_tabs(jx, table, names, r):
    return tuple(jx.jnp.asarray(getattr(table, nm)[r], jx.jnp.float32) for nm in names)


@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("name", NAMES)
def test_lane_ref_matches_pallas_interpret(jx, name, shard):
    js, ts = _pair(jx, name)
    r, nl = SHARDS[shard], 128
    f, hl, hr, ab = _inputs(ts, r, (6, nl), 1, seed=10 + r)
    block = shard_blocks(ts, P * nl, P)[r]
    got = dist.lane_dist_derivative_ref(*_t64(f, hl, hr, ab), DX, block)
    jdt = jx.jdt
    slt = (jdt.shard_lane_tables if js.derivative_order == 1 else jdt.shard_lane_fold_tables)(
        js, P * nl, P)
    tabs = _shard_tabs(jx, slt, type(slt).KERNEL_FIELDS, r)
    fn = lambda *a: jx.jdist.lane_dist_derivative(*a, DX, tabs, js, slt, interpret=True)
    want = jx.jax.jit(fn)(*(jx.jnp.asarray(a) for a in (f, hl, hr, np.moveaxis(ab, 1, -1))))
    assert _rel(want, got) < GATES[name]


@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("name", NAMES)
def test_sublane_ref_matches_pallas_interpret(jx, name, shard):
    js, ts = _pair(jx, name)
    r, nl = SHARDS[shard], 128
    f, hl, hr, ab = _inputs(ts, r, (2, nl, 128), 1, seed=20 + r)
    block = shard_blocks(ts, P * nl, P)[r]
    got = dist.sublane_dist_derivative_ref(*_t64(f, hl, hr, ab), DX, block, axis=1)
    jdt = jx.jdt
    slt = (jdt.shard_lane_tables if js.derivative_order == 1 else jdt.shard_lane_fold_tables)(
        js, P * nl, P)
    tabs = _shard_tabs(jx, slt, type(slt).KERNEL_FIELDS, r)
    fn = lambda *a: jx.jdist.sublane_dist_derivative(*a, DX, tabs, js, slt, axis=1,
                                                     interpret=True)
    want = jx.jax.jit(fn)(*(jx.jnp.asarray(a) for a in (f, hl, hr, ab)))
    assert _rel(want, got) < GATES[name]


@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("name", NAMES)
def test_leading_ref_matches_pallas_interpret(jx, name, shard):
    js, ts = _pair(jx, name)
    r, nl = SHARDS[shard], 64
    f, hl, hr, ab = _inputs(ts, r, (nl, 8, 128), 0, seed=30 + r)
    block = shard_blocks(ts, P * nl, P)[r]
    got = dist.leading_dist_derivative_ref(*_t64(f, hl, hr, ab), 1.0 / DX, block)
    skt = jx.jdt.shard_kernel_tables(js, P * nl, P)
    tabs = _shard_tabs(jx, skt, jx.jdt.ShardKernelTables.KERNEL_FIELDS, r)
    fn = lambda *a: jx.jleading.leading_dist_derivative(
        *a, 1.0 / DX, tabs, js, nb=skt.nb, rsupport=skt.rsupport, has_uh=skt.has_uh,
        has_lh=skt.has_lh, interpret=True)
    want = jx.jax.jit(fn)(*(jx.jnp.asarray(a) for a in (f, hl, hr, ab)))
    assert _rel(want, got) < GATES[name]


@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("name", NAMES)
def test_solve_lines_ref_matches_pallas_interpret(jx, name, shard):
    """Row 8: the generic route's local solve, no interface update, on flat
    (n, B) lines of an nl = 40 shard (too short for the fast path)."""
    js, ts = _pair(jx, name)
    r, nl = SHARDS[shard], 40
    f, hl, hr, _ = _inputs(ts, r, (nl, 256), 0, seed=40 + r)
    block = shard_blocks(ts, P * nl, P)[r]
    got = dist.solve_lines_tables_ref(*_t64(f, hl, hr), 1.0 / DX, block)
    jnp = jx.jnp
    tabs = _shard_tabs(jx, jx.jcompact.direction_tables(js, P * nl, P), ("tw", "tinvd", "tdu"), r)
    fn = lambda a, b, c: jx.jfused.solve_lines_tables_pallas(
        a, b, c, jnp.float32(1.0 / DX), *tabs, scheme=js, interpret=True)
    want = jx.jax.jit(fn)(*(jnp.asarray(a) for a in (f, hl, hr)))
    assert _rel(want, got) < GATES[name]


@pytest.mark.parametrize("name", ["SCHEME4", "SCHEME6", "SCHEME4_D2", "SCHEME6_D2", "filter6"])
def test_closure_rows_and_ghosts(jx, name):
    """The ghost rows equal cfd_tpu's, and the uniform stencil over them
    reproduces the closure rows the plain versions (and the kernels) form
    directly: ``compact_rhs`` of the whole line."""
    js, ts = _pair(jx, name)
    f = np.random.default_rng(1).standard_normal((24, 5))
    gl, gr = closure_ghosts(torch.from_numpy(f), ts)
    jgl, jgr = jx.jrhs.closure_ghosts(jx.jnp.asarray(f), js)
    assert np.abs(gl.numpy() - np.asarray(jgl)).max() < 1e-12 * np.abs(jgl).max()
    assert np.abs(gr.numpy() - np.asarray(jgr)).max() < 1e-12 * np.abs(jgr).max()
    ext = torch.cat([gl, torch.from_numpy(f), gr])
    ghost_form = stencil_rhs(ext, 1.0 / DX, ts)
    assert _rel(ghost_form, compact_rhs(torch.from_numpy(f), DX, ts)) < 1e-12
    block = shard_blocks(ts, 24, 1)[0]  # the whole line: closures at both ends
    zeros = torch.zeros_like(gl)
    direct = dist.solve_lines_tables_ref(torch.from_numpy(f), zeros, zeros, 1.0 / DX, block)
    via_ghosts = dist.solve_lines_tables_ref(torch.from_numpy(f), gl, gr, 1.0 / DX, block)
    assert _rel(direct, via_ghosts) < 1e-12


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    ts = tsch.SCHEME4
    block = shard_blocks(ts, 3 * 128, 3)[1]
    before = dict(dist.LAUNCHES)
    f, hl, hr, ab = (torch.from_numpy(a) for a in _inputs(ts, 1, (4, 128), 1, seed=3))
    got = dist.lane_dist_derivative(f, hl, hr, ab.movedim(1, -1).contiguous(), DX, block)
    want = dist.lane_dist_derivative_ref(f, hl, hr, ab.movedim(1, -1), DX, block)
    assert torch.equal(got, want)
    f, hl, hr, ab = (torch.from_numpy(a) for a in _inputs(ts, 1, (4, 128, 8), 1, seed=4))
    assert torch.equal(dist.sublane_dist_derivative(f, hl, hr, ab, DX, block, axis=1),
                       dist.sublane_dist_derivative_ref(f, hl, hr, ab, DX, block, axis=1))
    assert dist.LAUNCHES == before
    with pytest.raises(ValueError, match="line of 8 points"):
        dist.lane_dist_derivative(f, hl, hr, ab, DX, block)
    with pytest.raises(ValueError, match="contiguous"):
        dist.sublane_dist_derivative(f, hl, hr, ab, DX, block, axis=2)


def test_distributed_dots_refuse_tf32():
    """Every dot of the distributed layer (faces, reduced solve, dense local
    solve, the plain versions) raises while TF32 products are allowed."""
    shape = (8, 16, 256)
    grid = Grid(make_mesh((1, 1, 2), devices=["cpu"] * 2), shape, (0.1, 0.1, 0.1), tsch.SCHEME4)
    f = grid.distribute(torch.randn(shape, generator=torch.Generator().manual_seed(0)))
    solvers = [DistributedCompactSolver(grid, method=m) for m in ("kernel", "matmul")]
    for s in solvers:
        s.dfdx(f)  # full float32: runs
    before = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        for s in solvers:
            with pytest.raises(RuntimeError, match="full float32"):
                s.dfdx(f)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            solvers[0].dfdx(f)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    # float64 never takes TF32: no check
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        DistributedCompactSolver(grid, method="pcr").dfdx(
            grid.distribute(torch.zeros(shape, dtype=torch.float64)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(cuda, *arrays):
    return tuple(torch.from_numpy(a).to(cuda) for a in arrays)


@pytest.mark.gpu
@pytest.mark.parametrize("nl,lines", [(128, 300), (40, 7), (256, 33), (64, 45), (96, 70)])
@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("name", NAMES)
def test_lane_dist_kernel_matches_plain(cuda, name, shard, nl, lines):
    ts = _scheme(name)
    r = SHARDS[shard]
    f, hl, hr, ab = _card(cuda, *_inputs(ts, r, (lines, nl), 1, seed=50 + r))
    ab = ab.movedim(1, -1).contiguous()
    block = shard_blocks(ts, P * nl, P)[r]
    before = dist.LAUNCHES["lane_dist"]
    got = dist.lane_dist_derivative(f, hl, hr, ab, DX, block)
    torch.cuda.synchronize()
    assert dist.LAUNCHES["lane_dist"] == before + 1
    want = dist.lane_dist_derivative_ref(f.double(), hl.double(), hr.double(), ab.double(),
                                         DX, block)
    assert _rel(got.cpu(), want.cpu()) < GATES[name]


@pytest.mark.gpu
@pytest.mark.parametrize("axis,shape", [(1, (3, 128, 64)), (0, (64, 5, 33)), (1, (2, 40, 1)),
                                        (1, (2, 64, 37)), (1, (3, 96, 40)), (0, (96, 6, 20)),
                                        (0, (256, 3, 36))])
@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("name", NAMES)
def test_strided_dist_kernel_matches_plain(cuda, name, shard, axis, shape):
    ts = _scheme(name)
    r = SHARDS[shard]
    f, hl, hr, ab = _card(cuda, *_inputs(ts, r, shape, axis, seed=60 + r))
    block = shard_blocks(ts, P * shape[axis], P)[r]
    before = dict(dist.LAUNCHES)
    got = dist.sublane_dist_derivative(f, hl, hr, ab, DX, block, axis=axis)
    lines = dist.solve_lines_tables(f.reshape(shape[0], -1), hl.reshape(hl.shape[0], -1),
                                    hr.reshape(hr.shape[0], -1), 1.0 / DX,
                                    block) if axis == 0 else None
    torch.cuda.synchronize()
    assert dist.LAUNCHES["strided_dist"] == before["strided_dist"] + 1
    d = lambda t: t.double()
    want = dist.sublane_dist_derivative_ref(d(f), d(hl), d(hr), d(ab), DX, block, axis=axis)
    assert _rel(got.cpu(), want.cpu()) < GATES[name]
    if lines is not None:
        assert dist.LAUNCHES["strided_dist_lines"] == before["strided_dist_lines"] + 1
        want = dist.solve_lines_tables_ref(d(f).reshape(shape[0], -1),
                                           d(hl).reshape(hl.shape[0], -1),
                                           d(hr).reshape(hr.shape[0], -1), 1.0 / DX, block)
        assert _rel(lines.cpu(), want.cpu()) < GATES[name]


@pytest.mark.gpu
def test_dist_kernels_reject_what_they_do_not_take(cuda):
    ts = tsch.SCHEME4
    block = shard_blocks(ts, 3 * 128, 3)[1]
    f, hl, hr, ab = _card(cuda, *_inputs(ts, 1, (4, 128), 1, seed=5))
    ab = ab.movedim(1, -1).contiguous()
    with pytest.raises(TypeError, match="float32"):
        dist.lane_dist_derivative(f.double(), hl.double(), hr.double(), ab.double(), DX, block)
    with pytest.raises(ValueError, match="contiguous"):
        dist.lane_dist_derivative(f, hl, hr, ab.t().contiguous().t(), DX, block)
