"""The port's distributed dfdx along a (1, 1, 4) mesh against the whole line.

``DistributedCompactSolver.dfdx`` on meshes of four shards along x, held
against the benchmark's plain reference (``portbench/reference/ops.py``'s
``bounded_d1``: the float64 dense ``T^{-1} B`` of the whole bounded line,
built from the scheme's coefficients alone) on seeded random fields:

* on the CPU (every shard on the one device): float64 ``"pcr"`` at 1e-10,
  and the float32 ``"kernel"`` routes (the fast path with K11's plain
  version where the shard line is a multiple of 128 points, the generic
  route with K12's otherwise) at 1e-5 of the largest value, the float32
  recurrence tolerance: a line's solve in float32 keeps about six digits;
* on four cards (``gpu``, skipped below four): the mesh over ``cuda:0`` ...
  ``cuda:3`` equals the same mesh on ``cuda:0`` alone bitwise, since both
  run the same kernels on the same operands and a copy between cards moves
  bits unchanged; a call makes 18 copies between cards (6 halo slabs, 12
  face gathers) and none on one card, launches K11 once a shard, and after
  the first makes no copy from the host;
* across cards the solver replays the exchange (halos, faces, gather,
  reduced solve, up to the interface weights) from one CUDA graph fed the
  shards' end slabs (``parallel/graphs.py``), then launches K11/K12 on the
  field; that equals the call issued op by op bitwise (the same kernels on
  the same operands): on a new field each call as on a field seen before,
  with one graph for them all, along x, y and z; each replay counts the
  captured exchange's 18 copies and the end slabs it staged, K11 its own 4
  launches, and outputs held across later replays are distinct tensors that
  keep their values. On the CPU, and with every shard on one card, the call
  is issued op by op; ``Replays`` itself is also held against the plain
  call on one card (``gpu``, one card).
* on the CPU, the exchange on the end slabs (``graphs.stage_ends``, the
  first and last ``compact.ends_width`` points) equals the exchange on the
  whole field bitwise along x, y and z, for ``pade4`` and ``lele6``,
  periodic and bounded, staged and whole; ``ends_width`` is the largest of
  the faces', ghosts' and halos' reads, and slabs one point short change
  the weights.
"""

from __future__ import annotations

import pytest
import torch

from cfd_tpu_torch.ops import dist
from cfd_tpu_torch.parallel import DistributedCompactSolver, Grid, make_mesh
from cfd_tpu_torch.parallel import dist_tables
from cfd_tpu_torch.parallel.compact import (_dist_faces, dist_exchange, dist_fast, dist_replayed,
                                             end_reads, ends_width)
from cfd_tpu_torch.parallel.graphs import Replays, replayable, stage_ends
from cfd_tpu_torch.schemes import SCHEME4, SCHEME4_PERIODIC, SCHEME6, SCHEME6_PERIODIC
from portbench.reference.ops import FLOAT64, bounded_d1, bounded_d1_apply

LOCALS = [(4, 6, 128), (3, 5, 64)]


def _solver(local, devices, method="auto"):
    nz, ny, nx = local
    shape = (nz, ny, 4 * nx)
    h = 0.7 / (shape[2] - 1)
    grid = Grid(make_mesh((1, 1, 4), devices), shape, (h, h, h), SCHEME4)
    return DistributedCompactSolver(grid, method=method)


def _field(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _gap(solver, f):
    """max |dfdx - D f| / max |D f|, D the whole line's float64 operator."""
    grid = solver.grid
    out = torch.as_tensor(grid.gather(solver.dfdx(grid.distribute(f)))).double()
    d = bounded_d1(grid.shape[2], grid.spacing[2], FLOAT64, "cpu")
    ref = bounded_d1_apply(f.double(), d, 2, FLOAT64)
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("local", LOCALS)
def test_float64_pcr_matches_the_whole_line(local):
    solver = _solver(local, ["cpu"] * 4, method="pcr")
    f = _field(solver.grid.shape, torch.float64, 11)
    assert solver.route(solver.grid.distribute(f), 2) == "pcr"
    assert _gap(solver, f) < 1e-10


@pytest.mark.parametrize("local,route", [(LOCALS[0], "fast"), (LOCALS[1], "kernel")])
def test_float32_kernel_routes_match_the_whole_line(local, route):
    solver = _solver(local, ["cpu"] * 4, method="kernel")
    f = _field(solver.grid.shape, torch.float32, 12)
    assert solver.route(solver.grid.distribute(f), 2) == route
    assert _gap(solver, f) < 1e-5


def test_one_device_makes_no_peer_copy():
    solver = _solver(LOCALS[0], ["cpu"] * 4, method="kernel")
    f = solver.grid.distribute(_field(solver.grid.shape, torch.float32, 13))
    before = dict(dist.PEER_COPIES)
    solver.dfdx(f)
    assert dist.PEER_COPIES == before


def test_the_inverse_rows_are_cached_on_the_shards_device():
    # the reduced solve reads each shard's rows of the reduced-matrix
    # inverse from the per-device cache, not from the host on every call
    solver = _solver(LOCALS[0], ["cpu"] * 4, method="kernel")
    f = solver.grid.distribute(_field(solver.grid.shape, torch.float32, 14))
    solver.dfdx(f)
    tables = dist_tables.shard_kernel_tables(SCHEME4, solver.grid.shape[2], 4)
    cached = {k: t for k, t in dist_tables._TENSORS.items()
              if k[0] == id(tables) and k[1] == "rinv_rows"}
    assert sorted(k[2] for k in cached) == [0, 1, 2, 3]
    assert all(t.dtype == torch.float64 and t.device.type == "cpu" for t in cached.values())
    solver.dfdx(f)
    again = {k: t for k, t in dist_tables._TENSORS.items() if k in cached}
    assert all(again[k] is cached[k] for k in cached)


def _plain(solver, f):
    grid = solver.grid
    return dist_fast(f, 2, scheme=grid.scheme, n=grid.shape[2], p=grid.proc_shape[2],
                     dx=grid.spacing[2])


def test_graphed_is_the_plain_call_on_the_cpu():
    # off CUDA the fast path is issued op by op: no graph is captured
    solver = _solver(LOCALS[0], ["cpu"] * 4, method="kernel")
    f = solver.grid.distribute(_field(solver.grid.shape, torch.float32, 17))
    assert not replayable(f)
    got, want = solver.dfdx(f), _plain(solver, f)
    assert len(solver._replays) == 0
    assert all(torch.equal(a, b) for a, b in zip(got.shards, want.shards))


EXCHANGES = [(scheme, axis, nl) for scheme in (SCHEME4, SCHEME4_PERIODIC, SCHEME6, SCHEME6_PERIODIC)
             for axis in (2, 1, 0) for nl in (128, 24)]


def _along(axis, nl, devices, scheme=SCHEME4):
    """A grid of four shards along ``axis``, ``nl`` points a shard line."""
    mesh, local = [1, 1, 1], [3, 5, 6]
    mesh[axis], local[axis] = 4, nl
    shape = tuple(m * k for m, k in zip(mesh, local))
    h = 0.7 / (shape[axis] - 1)
    return Grid(make_mesh(mesh, devices), shape, (h, h, h), scheme)


def _equal(a, b):
    return all(torch.equal(x, y) for pa, pb in zip(a, b) for x, y in zip(pa.shards, pb.shards))


@pytest.mark.parametrize("scheme,axis,nl", EXCHANGES,
                         ids=[f"{s.name}-{'zyx'[a]}-{nl}" for s, a, nl in EXCHANGES])
def test_the_exchange_on_the_end_slabs_is_the_exchange_on_the_field(scheme, axis, nl):
    grid = _along(axis, nl, ["cpu"] * 4, scheme)
    f = grid.distribute(_field(grid.shape, torch.float32, 31))
    n = grid.shape[axis]
    kw = dict(scheme=scheme, n=n, p=4, dx=grid.spacing[axis])
    reads = end_reads(scheme, n, 4)
    width = ends_width(scheme, n, 4)
    staged = nl == 128
    assert 2 * max(reads.values()) < nl if staged else 2 * max(reads.values()) >= nl
    assert width == (max(reads.values()) if staged else nl)

    def exchange(ends):
        # the operands, and the float64 faces: a slab one point short moves
        # a face by its functional's outermost weight (~1e-9 of it), which
        # the float32 weights may round away
        hl, hr, weights = dist_exchange(ends, axis, **kw)
        faces = _dist_faces(ends, hl, hr, axis, scheme=scheme, n=n, p=4, inv_dx=1.0 / kw["dx"])
        return (hl, hr, weights) + faces

    def on_ends(width):
        ends = f.map(lambda s: stage_ends(s, axis - 3, width))
        assert ends.local_shape[axis] == (2 * width if staged else nl)
        return exchange(ends)

    want = exchange(f)
    assert _equal(on_ends(width), want)
    if staged:
        assert not _equal(on_ends(width - 1), want)


def _four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    return [torch.device("cuda", i) for i in range(4)]


@pytest.mark.gpu
def test_four_cards_equal_one_card():
    cards = _four_cards()
    local = (32, 64, 512)
    spread = _solver(local, cards)
    shared = _solver(local, [cards[0]] * 4)
    f = _field(spread.grid.shape, torch.float32, 15)
    fa, fb = spread.grid.distribute(f), shared.grid.distribute(f)
    assert spread.route(fa, 2) == "fast" and shared.route(fb, 2) == "fast"
    spread.dfdx(fa), shared.dfdx(fb)  # the first call builds and caches the tables

    def counted(solver, x):
        copies, launches = dist.PEER_COPIES["copies"], dist.LAUNCHES["lane_dist"]
        out = solver.dfdx(x)
        return out, dist.PEER_COPIES["copies"] - copies, dist.LAUNCHES["lane_dist"] - launches

    out_a, copies_a, k11_a = counted(spread, fa)
    out_b, copies_b, k11_b = counted(shared, fb)
    assert (copies_a, k11_a) == (18, 4)
    assert (copies_b, k11_b) == (0, 4)
    assert [s.device for s in out_a.shards] == cards
    for a, b in zip(out_a.shards, out_b.shards):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
def test_a_call_across_cards_copies_nothing_from_the_host():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cards = _four_cards()
    solver = _solver((32, 64, 512), cards)
    f = solver.grid.distribute(_field(solver.grid.shape, torch.float32, 16))
    solver.dfdx(f)
    for d in cards:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solver.dfdx(f)
        for d in cards:
            torch.cuda.synchronize(d)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert not [n for n in names if "HtoD" in n], sorted(set(names))
    assert sum("lane_dist_kernel" in n for n in names) == 4, sorted(set(names))


@pytest.mark.gpu
def test_graph_replays_equal_the_plain_call_across_cards():
    cards = _four_cards()
    solver = _solver((32, 64, 512), cards)
    fields = [solver.grid.distribute(_field(solver.grid.shape, torch.float32, s))
              for s in (18, 19)]
    assert replayable(fields[0])
    held = solver.dfdx(fields[0])  # the capture, then its first replay
    kept = [s.clone() for s in held.shards]
    # fields seen before, then a new field (new shards) each call
    fresh = (solver.grid.distribute(_field(solver.grid.shape, torch.float32, s))
             for s in (20, 21, 22))
    for f in fields + [fields[0]] + list(fresh):
        copies, launches = dist.PEER_COPIES["copies"], dist.LAUNCHES["lane_dist"]
        got = solver.dfdx(f)
        assert (dist.PEER_COPIES["copies"] - copies, dist.LAUNCHES["lane_dist"] - launches) \
            == (18, 4)
        want = _plain(solver, f)
        assert [s.device for s in got.shards] == cards
        assert all(torch.equal(a, b) for a, b in zip(got.shards, want.shards))
    assert len(solver._replays) == 1
    assert all(torch.equal(a, b) for a, b in zip(held.shards, kept))


@pytest.mark.gpu
def test_a_replay_on_one_card_equals_the_plain_call():
    # the staging of the end slabs, the exchange's replay and the kernels
    # after it, on a mesh on cuda:0 alone (where the solver itself issues
    # the call op by op)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    solver = _solver((32, 64, 512), ["cuda:0"] * 4)
    fields = [solver.grid.distribute(_field(solver.grid.shape, torch.float32, s))
              for s in (23, 24, 25)]
    assert not replayable(fields[0])
    replays = Replays()
    grid = solver.grid
    kw = dict(scheme=grid.scheme, n=grid.shape[2], p=4, dx=grid.spacing[2])
    held = dist_replayed(replays, fields[0], 2, **kw)
    kept = [s.clone() for s in held.shards]
    for f in fields + [solver.grid.distribute(_field(solver.grid.shape, torch.float32, 26))]:
        launches = dist.LAUNCHES["lane_dist"]
        got = dist_replayed(replays, f, 2, **kw)
        assert dist.LAUNCHES["lane_dist"] - launches == 4
        want = _plain(solver, f)
        assert all(torch.equal(a, b) for a, b in zip(got.shards, want.shards))
    assert len(replays) == 1
    assert all(torch.equal(a, b) for a, b in zip(held.shards, kept))


def _counts():
    return (dict(dist.STAGED), dist.LAUNCHES["lane_dist"] + dist.LAUNCHES["strided_dist"],
            dist.PEER_COPIES["copies"])


@pytest.mark.gpu
def test_a_replay_stages_the_end_slabs_and_its_outputs_stay():
    cards = _four_cards()
    solver = _solver((32, 64, 512), cards)
    grid = solver.grid
    fields = [grid.distribute(_field(grid.shape, torch.float32, s)) for s in (27, 28, 29)]
    solver.dfdx(fields[0])  # the capture, then its first replay
    width = ends_width(SCHEME4, grid.shape[2], 4)
    assert width == 18
    outs = []
    for f in fields:
        staged, launches, copies = _counts()
        outs.append(solver.dfdx(f))
        after = _counts()
        assert after[0]["replays"] - staged["replays"] == 1
        assert after[0]["bytes"] - staged["bytes"] == 4 * 2 * width * 32 * 64 * 4
        assert (after[1] - launches, after[2] - copies) == (4, 18)
    assert len({s.data_ptr() for out in outs for s in out.shards}) == 12
    for f, out in zip(fields, outs):
        assert all(torch.equal(a, b) for a, b in zip(out.shards, _plain(solver, f).shards))
    assert len(solver._replays) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("axis,nl", [(1, 128), (0, 64)])
def test_y_and_z_replays_equal_the_plain_call(axis, nl):
    cards = _four_cards()
    grid = _along(axis, nl, cards)
    solver = DistributedCompactSolver(grid)
    kw = dict(scheme=grid.scheme, n=grid.shape[axis], p=4, dx=grid.spacing[axis])
    fields = [grid.distribute(_field(grid.shape, torch.float32, s)) for s in (32, 33)]
    assert solver.route(fields[0], axis) == "fast" and replayable(fields[0])
    solver.apply(fields[0], axis)  # the capture
    width = ends_width(grid.scheme, grid.shape[axis], 4)
    for f in fields + [fields[0], grid.distribute(_field(grid.shape, torch.float32, 34))]:
        staged, launches, _ = _counts()
        got = solver.apply(f, axis)
        after = _counts()
        assert after[0]["bytes"] - staged["bytes"] == 4 * 2 * width * f.shards[0].numel() // nl * 4
        assert after[1] - launches == 4
        want = dist_fast(f, axis, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got.shards, want.shards))
    assert len(solver._replays) == 1
