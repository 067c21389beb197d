"""Shard-local solves of distributed compact derivatives: kernels K11 and K12.

The port of ``cfd_tpu/ops/pallas_dist.py`` (the lane and sublane forms),
of the distributed mode of ``cfd_tpu/ops/pallas_leading.py``
(``leading_dist_derivative``) and of ``solve_lines_tables_pallas``
(``cfd_tpu/ops/pallas_fused.py``). When a derivative crosses a sharded
mesh axis, each shard solves its truncated local block

    x = T_r^{-1} rhs(f ⊕ halos) + a * suh + b * slh

with ``rhs`` the scheme's stencil over the shard's line extended by the w
halo rows of its neighbours, ``T_r`` the shard's own local block (closure
rows on the end shards of a non-periodic line, never a cyclic corner: the
ring of a periodic line closes in the reduced system), and ``(a, b)`` the
shard's outer interface weights from the reduced solve
(``parallel/compact.py``), applied with the unit loads ``suh``/``slh``.
The end shards of a non-periodic line form their closure rows from f
itself, as K1 and K2 do; their halo rows on the open side are not read.

On a CUDA float32 tensor:

* ``lane_dist_derivative`` launches K11 ``lane_dist`` (``csrc/lane_dist.cu``)
  on x-lines ``(..., nl)``: rows 9 and 10 of the kernel table
  (``_lane_dist_kernel``, roll form; ``_lane_dist_fold_kernel``, fold
  form), one kernel for every scheme order;
* ``sublane_dist_derivative`` (y) and ``leading_dist_derivative`` (z)
  launch K12 ``strided_dist`` (``csrc/strided_dist.cu``) down a strided
  axis: rows 11 and 12 (``_sublane_dist_kernel``,
  ``_sublane_dist_fold_kernel``) and row 6 (``_leading_kernel`` in its
  ``ext`` mode);
* ``solve_lines_tables`` launches K12 without the interface update, on
  flat ``(n, B)`` lines: row 8 (``_fused_kernel``), the local solve of the
  generic distributed route.

Both kernels stage a tile of lines in shared memory once and cut each
line into ``parallel.dist_tables.pick_nb(nl)`` sub-blocks, one thread per
sub-block's Thomas chain, joined by an intra-shard reduced solve
(``csrc/dist_common.cuh``).

On a CPU tensor each returns its plain version (``*_ref``): the stencil
over the halo-extended line (``ops/rhs.py``), the shard's dense
``T_r^{-1}`` and the update. ``LAUNCHES`` counts kernel launches by kernel:
a launch adds to it, and so does a replay of a CUDA graph, by the launches
its captured call made (``parallel/graphs.py``); the capture itself adds
nothing. The fast path's graph holds its exchange alone: K11 and K12 run
after the replay and count their own launches.
``PEER_COPIES`` counts the distributed layer's copies between two devices
(``parallel/mesh.py``'s ``ppermute`` and ``all_gather``) and their bytes, a
replay those of its captured call; a shard that stays on its device adds
nothing. ``STAGED`` counts the replays of the fast path's exchange and the
bytes each copied into its graph's input buffers (the shards' end slabs,
``parallel/graphs.py``'s ``stage_ends``), summed over the cards. Both live
here, beside ``LAUNCHES``, where the benchmark's counter reader looks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..schemes import CompactScheme
from . import _native
from .rhs import shard_rhs

__all__ = [
    "LAUNCHES",
    "PEER_COPIES",
    "STAGED",
    "ShardBlock",
    "require_full_f32",
    "lane_dist_supported",
    "leading_dist_supported",
    "lane_dist_derivative",
    "lane_dist_derivative_ref",
    "sublane_dist_derivative",
    "sublane_dist_derivative_ref",
    "leading_dist_derivative",
    "leading_dist_derivative_ref",
    "solve_lines_tables",
    "solve_lines_tables_ref",
]

LAUNCHES = {"lane_dist": 0, "strided_dist": 0, "strided_dist_lines": 0}
PEER_COPIES = {"copies": 0, "bytes": 0}
STAGED = {"replays": 0, "bytes": 0}

_LANE = 128


@dataclasses.dataclass(frozen=True, eq=False)
class ShardBlock:
    """One shard's truncated local system, float64 numpy (``nl`` rows).

    ``first``/``last``: the shard holds the line's physical left/right end
    of a non-periodic scheme, and its block the closure rows there.
    ``tinv``: the block's dense inverse; ``suh``/``slh``: the unit-load
    solutions that carry the couplings to the neighbouring shards. Built by
    ``parallel.dist_tables.shard_blocks``; hashed by identity, so cached
    launch tables key on it.
    """

    scheme: CompactScheme
    first: bool
    last: bool
    tinv: np.ndarray
    suh: np.ndarray
    slh: np.ndarray

    @property
    def nl(self) -> int:
        return self.suh.shape[0]


def require_full_f32(dtype: torch.dtype) -> None:
    """Raise unless float32 matrix products run in full float32.

    The distributed layer's dots (interface faces, reduced solve, dense
    local solve) decide every shard boundary: in TF32 (three decimal
    digits) they corrupt it, as bf16 passes do on the TPU's matrix unit
    without ``Precision.HIGHEST``."""
    if dtype == torch.float32 and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "the distributed compact solve needs full float32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')"
        )


# nl % 128 == 0 and the 128-point floor are the TPU's lane tiling
# (pallas_dist.py:51-59), kept so that a shard shape takes the same route
# as in the JAX package; K11 and K12 take any nl >= min_points.
def lane_dist_supported(scheme: CompactScheme, nl: int, dtype) -> bool:
    """Whether the x or y local solve of ``nl``-point shard lines takes the
    dist kernels (the JAX package's ``lane_dist_supported``)."""
    return dtype == torch.float32 and nl % _LANE == 0 and nl >= max(scheme.min_points(), _LANE)


def leading_dist_supported(scheme: CompactScheme, nl: int, dtype) -> bool:
    """Whether the z local solve of ``nl`` rows takes K12 (the JAX
    package's ``leading_dist_supported``)."""
    return dtype == torch.float32 and nl >= max(scheme.min_points(), 2 * scheme.stencil_width + 2)


def _line_view(x: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=t.dtype, device=t.device).reshape((-1,) + (1,) * (t.ndim - 1))


def _block_ref(f, hl, hr, ab, inv_dx, block: ShardBlock) -> torch.Tensor:
    """The plain version along axis 0: f (nl, *b), hl/hr (w, *b), ab (2, *b)
    or None."""
    require_full_f32(f.dtype)
    r = shard_rhs(f, hl, hr, inv_dx, block.scheme, block.first, block.last)
    tinv = torch.as_tensor(block.tinv, dtype=f.dtype, device=f.device)
    x = torch.tensordot(tinv, r, dims=([1], [0]))
    if ab is not None:
        x = x + ab[0:1] * _line_view(block.suh, x) + ab[1:2] * _line_view(block.slh, x)
    return x


def _along(axis: int, f, hl, hr, ab, inv_dx, block) -> torch.Tensor:
    """``_block_ref`` with the line along ``axis`` of every operand."""
    mv = lambda t: None if t is None else t.movedim(axis, 0)
    return _block_ref(mv(f), mv(hl), mv(hr), mv(ab), inv_dx, block).movedim(0, axis).contiguous()


def lane_dist_derivative_ref(f, hl, hr, ab, dx, block: ShardBlock) -> torch.Tensor:
    """The plain version of ``lane_dist_derivative``."""
    return _along(-1, f, hl, hr, ab, 1.0 / dx, block)


def sublane_dist_derivative_ref(f, hl, hr, ab, dx, block: ShardBlock, *, axis: int) -> torch.Tensor:
    """The plain version of ``sublane_dist_derivative``."""
    return _along(axis, f, hl, hr, ab, 1.0 / dx, block)


def leading_dist_derivative_ref(fl, gl, gr, ab, inv_dx, block: ShardBlock) -> torch.Tensor:
    """The plain version of ``leading_dist_derivative``."""
    return _along(0, fl, gl, gr, ab, inv_dx, block)


def solve_lines_tables_ref(f, gl, gr, inv_dx, block: ShardBlock) -> torch.Tensor:
    """The plain version of ``solve_lines_tables``."""
    return _along(0, f, gl, gr, None, inv_dx, block)


def _check(name, f, hl, hr, ab, axis, block, ab_rows=2):
    """The operands' shapes, and their layout on every device: contiguous,
    as the kernels read them."""
    axis = axis % f.ndim
    w = block.scheme.stencil_width
    if f.shape[axis] != block.nl:
        raise ValueError(f"{name}: line of {f.shape[axis]} points, shard block of {block.nl}")
    want = lambda rows: f.shape[:axis] + (rows,) + f.shape[axis + 1 :]
    named = (("hl", hl, w), ("hr", hr, w)) + ((("ab", ab, ab_rows),) if ab is not None else ())
    for label, t, rows in named:
        if tuple(t.shape) != want(rows):
            raise ValueError(f"{name}: {label} shape {tuple(t.shape)} != {want(rows)}")
    if not all(t.is_contiguous() for t in (f, hl, hr) + ((ab,) if ab is not None else ())):
        raise ValueError(f"{name} takes contiguous tensors")


def lane_dist_derivative(f, hl, hr, ab, dx, block: ShardBlock) -> torch.Tensor:
    """One shard's local x solve: ``f`` (..., nl), ``hl``/``hr`` (..., w)
    halo lanes, ``ab`` (..., 2) outer interface weights; K11 on CUDA
    float32, the plain version on a CPU tensor."""
    _check("lane_dist", f, hl, hr, ab, -1, block)
    if f.device.type == "cpu":
        return lane_dist_derivative_ref(f, hl, hr, ab, dx, block)
    out = _launch("lane_dist", f, hl, hr, ab, dx, block, f.ndim - 1)
    LAUNCHES["lane_dist"] += 1
    return out


def sublane_dist_derivative(f, hl, hr, ab, dx, block: ShardBlock, *, axis: int) -> torch.Tensor:
    """One shard's local solve along a non-minor ``axis`` (y): ``hl``/``hr``
    carry w halo planes along ``axis``, ``ab`` two interface planes; K12 on
    CUDA float32, the plain version on a CPU tensor."""
    axis = axis % f.ndim
    if axis == f.ndim - 1:
        raise ValueError("the last axis is contiguous: use lane_dist_derivative")
    _check("strided_dist", f, hl, hr, ab, axis, block)
    if f.device.type == "cpu":
        return sublane_dist_derivative_ref(f, hl, hr, ab, dx, block, axis=axis)
    out = _launch("strided_dist", f, hl, hr, ab, dx, block, axis)
    LAUNCHES["strided_dist"] += 1
    return out


def leading_dist_derivative(fl, gl, gr, ab, inv_dx, block: ShardBlock) -> torch.Tensor:
    """One shard's local z solve: ``fl`` (nl, *batch) in native layout,
    ``gl``/``gr`` (w, *batch) halo rows, ``ab`` (2, *batch); K12 on CUDA
    float32, the plain version on a CPU tensor."""
    if fl.ndim < 2:
        raise ValueError("leading_dist_derivative needs (nl, *batch) with a batch")
    return sublane_dist_derivative(fl, gl, gr, ab, 1.0 / inv_dx, block, axis=0)


def solve_lines_tables(f, gl, gr, inv_dx, block: ShardBlock) -> torch.Tensor:
    """The local solve of the generic distributed route: stencil over the
    halo-extended lines ``f`` (n, B) and the block's Thomas solve, no
    interface update; K12 on CUDA float32, the plain version on CPU."""
    if f.ndim != 2:
        raise ValueError(f"solve_lines_tables takes (n, B) lines, got {tuple(f.shape)}")
    _check("strided_dist_lines", f, gl, gr, None, 0, block)
    if f.device.type == "cpu":
        return solve_lines_tables_ref(f, gl, gr, inv_dx, block)
    out = _launch("strided_dist_lines", f, gl, gr, None, 1.0 / inv_dx, block, 0)
    LAUNCHES["strided_dist_lines"] += 1
    return out


def _chain_table(block: ShardBlock):
    """(float64 table, nb): what K11/K12 read of a shard block cut into
    ``nb = pick_nb(nl)`` sub-blocks. Point after point, the eight values a
    chain reads at a row (``csrc/dist_common.cuh``, ``DIST_TAB_*``): the
    sub-block factors invd and du, the intra unit loads uh and lh, the shard
    unit loads suh and slh, the forward multiplier w and t0
    (``parallel.dist_tables.local_block_tables``), between a zero row before
    row 0 and one after row nl - 1 (the sweeps load a row ahead); then the
    (2nb, 2nb) intra reduced inverse, row-major."""
    from ..parallel.dist_tables import local_block_tables, pick_nb

    nb = pick_nb(block.nl)
    t = local_block_tables(block.scheme, block.nl, block.first, block.last, nb)
    rows = np.stack([t.invd, t.du, t.uh, t.lh, block.suh, block.slh, t.w, t.t0], axis=1)
    rows = np.pad(rows, ((1, 1), (0, 0)))
    return np.concatenate([rows.ravel(), t.rinv.ravel()]), nb


@functools.lru_cache(maxsize=256)
def _launch_tables(block: ShardBlock, dx: float, device: torch.device):
    """(Coef, float32 table, nb) for K11/K12: ``_chain_table`` rounded once.

    The Coef is the scheme's (``_native.kernel_tables``) with no cyclic
    part: the kernels read its stencil and closure rows, never its
    Sherman–Morrison scalars."""
    coef, _ = _native.kernel_tables(block.scheme, block.nl)
    coef = {**coef, "periodic": 0, "v0": 0.0, "vn": 0.0, "inv_denom": 0.0}
    scale = (1.0 / dx) ** block.scheme.derivative_order
    tab, nb = _chain_table(block)
    return (_native.fill_coef(coef, scale),
            torch.as_tensor(tab, dtype=torch.float32, device=device), nb)


def _launch(kernel, f, hl, hr, ab, dx, block: ShardBlock, axis: int) -> torch.Tensor:
    """One launch of K11 (``axis`` last) or K12 on CUDA tensors."""
    _native.check_order(block.scheme)
    _native.check_operands(kernel, f, hl, hr, *((ab,) if ab is not None else ()))
    coef, tab, nb = _launch_tables(block, float(dx), f.device)
    out = torch.empty_like(f)
    outer = math.prod(f.shape[:axis])
    inner = math.prod(f.shape[axis + 1 :])
    if outer * inner == 0:
        return out
    lib = _native.library()
    stream = torch.cuda.current_stream(f.device).cuda_stream
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(f.device):
        if kernel == "lane_dist":
            err = lib.cfd_lane_dist(
                f.data_ptr(), hl.data_ptr(), hr.data_ptr(), ab.data_ptr(), out.data_ptr(),
                tab.data_ptr(), ctypes.byref(coef), outer, nb, int(block.first),
                int(block.last), stream,
            )
        else:
            err = lib.cfd_strided_dist(
                f.data_ptr(), hl.data_ptr(), hr.data_ptr(), ptr(ab), out.data_ptr(),
                tab.data_ptr(), ctypes.byref(coef), outer, inner, nb, int(block.first),
                int(block.last), stream,
            )
    _native.check(err, kernel)
    return out
