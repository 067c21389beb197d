"""Compact derivative along the contiguous last axis (d/dx, d²/dx²): kernel K1.

The port of ``cfd_tpu/ops/pallas_lane.py``. On a CUDA float32 tensor
``lane_derivative`` launches ``compact_lane`` (``csrc/compact_lane.cu``),
which replaces both of that module's derivative kernels: the fold form
``_lane_fold_kernel`` (first and second derivatives and filters) and the
roll form ``_lane_kernel`` (first). The scheme's tables select the
derivative, or the filter (``derivative_order=0``, ``schemes.get_filter``:
no spacing scale). On a CPU tensor it returns ``lane_derivative_ref``, the
plain PyTorch version.

The kernel cuts each line into ``line_nb(n)`` sub-blocks and runs their
Thomas chains side by side, one thread a chain (``csrc/line_chains.cuh``),
against ``chain_table``; on a line whose length has no divisor that leaves
chains of at least 32 rows (n < 64, a prime n) the one chain is the whole
line.

``LAUNCHES`` counts the launches of ``lane_derivative``, so that a run can
show that its path went through the kernel, and ``MODE_LAUNCHES`` the same
launches by mode (``"derivative"`` or ``"filter"``); nothing but the launch
adds to them. ``launch`` is the bare launch, with the kernel's ``acc``
epilogue (``f' + acc``), for ``ops/pair.py``, which counts its own calls.

The y phase of ``csrc/xy_phase.cuh`` (K3, K5, K6, K9, K13) runs the same
chains down the y-lines of a block's columns staged in shared memory, on
the tables that ``y_tables`` gives its wrappers; ``y_phase_fits`` says
where one column's tiles fit the card's opt-in maximum, and the wrappers'
predicates decline the y-lines where they do not.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..schemes import CompactScheme
from . import _native
from .dense import dense_derivative

__all__ = [
    "LAUNCHES", "MODE_LAUNCHES", "chain_table", "launch", "lane_derivative",
    "lane_derivative_ref", "line_nb", "y_phase_fits", "y_tables", "y_tile_bytes",
]

LAUNCHES = 0
MODE_LAUNCHES = {"derivative": 0, "filter": 0}

CHAIN_ROWS = 32  # the fewest rows of a chain
CHAIN_MAX = 128  # the most chains line_nb gives a line
# reduced-inverse entries below this share of the largest are dropped from
# a chain's window (csrc/line_chains.cuh): two decades under float64
_RINV_TOL = 1e-14


def line_nb(n: int) -> int:
    """The sub-blocks K1 cuts a line of ``n`` points into: the most that
    divide n into chains of at least CHAIN_ROWS rows, at most CHAIN_MAX; 1
    (one chain, the whole line) where none does."""
    return max((nb for nb in range(2, min(CHAIN_MAX, n // CHAIN_ROWS) + 1) if n % nb == 0),
               default=1)


@functools.lru_cache(maxsize=None)
def chain_table(scheme: CompactScheme, n: int, nb: int):
    """(float64 table, h, win): what K1's chains read on a line of ``n``
    points cut into ``nb`` sub-blocks (``csrc/line_chains.cuh``), from
    ``parallel.dist_tables.line_block_tables``.

    The per-row part holds three kinds of sub-block, the first, the second
    (an interior one, as every sub-block but the ends is) and the last,
    each between zero rows: float4 rows (invd, du, uh, lh), then float2
    rows (w, t0). Then each chain's window of its two reduced rows, (2,
    win, nb), win = min(2h + 2, 2nb) columns from c0(k) = 2k - h (mod 2nb
    on a periodic line, clamped into [0, 2nb - win] otherwise), with h the
    least that keeps every entry above ``_RINV_TOL`` of the largest."""
    from ..parallel.dist_tables import line_block_tables

    t = line_block_tables(scheme, n, nb)
    bz = n // nb
    blocks = {name: getattr(t, name).reshape(nb, bz)
              for name in ("invd", "du", "uh", "lh", "w", "t0")}
    kinds = (0, min(1, nb - 1), nb - 1)
    for name, v in blocks.items():
        if any(not np.array_equal(v[b], v[kinds[1]]) for b in range(1, nb - 1)):
            raise AssertionError(f"interior sub-blocks of {scheme.name} differ in {name}")
    def rows(names):
        return np.concatenate([np.pad(np.stack([blocks[x][q] for x in names], axis=1),
                                      ((1, 1), (0, 0))) for q in kinds])
    m = 2 * nb
    rinv = t.rinv
    big = np.abs(rinv) > _RINV_TOL * np.abs(rinv).max()
    h = 0
    for r in range(m):
        d = np.nonzero(big[r])[0] - 2 * (r // 2)
        if scheme.periodic:
            d = (d + nb) % m - nb
        if d.size:
            h = max(h, int((-d).max()), int((d - 1).max()))
    win = min(2 * h + 2, m)
    k = np.arange(nb)
    c0 = (2 * k - h) % m if scheme.periodic else np.clip(2 * k - h, 0, m - win)
    cols = (c0[:, None] + np.arange(win)) % m  # (nb, win)
    red = np.stack([rinv[2 * k[:, None], cols], rinv[2 * k[:, None] + 1, cols]])
    table = np.concatenate([rows(("invd", "du", "uh", "lh")).ravel(),
                            rows(("w", "t0")).ravel(), red.transpose(0, 2, 1).ravel()])
    return table, h, win


@functools.lru_cache(maxsize=64)
def _chain_launch_tables(scheme: CompactScheme, n: int, nb: int, dx: float, device):
    """(Coef, float32 chain table on ``device``, h, win) for one launch of
    K1, or of either phase of K3, K5, K6, K9 and K13 (``ops/adv_lap.py``,
    ``ops/vec.py``, ``ops/pair.py``), which run the same chains."""
    coef, _ = _native.kernel_tables(scheme, n)
    table, h, win = chain_table(scheme, n, nb)
    scale = (1.0 / dx) ** scheme.derivative_order
    return (_native.fill_coef(coef, scale),
            torch.as_tensor(table, dtype=torch.float32, device=device), h, win)


def y_tile_bytes(ny: int, nb: int, tiles: int, cols: int = 1) -> int:
    """The shared memory of a y-phase block of ``cols`` columns of ``ny``
    rows in ``nb`` chains (``xy_y_bytes`` in ``csrc/xy_phase.cuh``):
    ``tiles`` tiles (two for a pair) and each tile's 2 nb face slots a
    column."""
    return 4 * cols * tiles * (ny + 2 * nb)


def y_phase_fits(ny: int, tiles: int, device) -> bool:
    """Whether the staged y phase takes y-lines of ``ny`` points with
    ``tiles`` tiles a column (two for a pair) on ``device``: one column's
    tiles and faces within ``_native.smem_limit(device)``. Off the card no
    limit holds."""
    limit = _native.smem_limit(device)
    return limit is None or y_tile_bytes(ny, line_nb(ny), tiles) <= limit


def y_tables(schemes, ny: int, dy, device):
    """``(nb, [(Coef, float32 table on device, h, win) a scheme])``: what the
    y phase of ``csrc/xy_phase.cuh`` reads for y-lines of ``ny`` points, one
    tile a scheme of ``schemes`` (a pair's two, or one): ``nb =
    line_nb(ny)`` sub-blocks a y-line and each scheme's ``chain_table``.
    Raises where one column's tiles pass the card's opt-in maximum
    (``y_phase_fits``)."""
    nb = line_nb(ny)
    if not y_phase_fits(ny, len(schemes), device):
        raise ValueError(
            f"y phase: a column of {ny} points in {len(schemes)} tiles takes "
            f"{y_tile_bytes(ny, nb, len(schemes))} bytes of shared memory, past the "
            f"{_native.smem_limit(device)} a block may take on {device}")
    return nb, [_chain_launch_tables(s, ny, nb, float(dy), device) for s in schemes]


def lane_derivative_ref(f: torch.Tensor, dx, scheme: CompactScheme) -> torch.Tensor:
    """The plain PyTorch version: the dense operator along the last axis."""
    return dense_derivative(f, dx, scheme, -1)


def lane_derivative(f: torch.Tensor, dx, scheme: CompactScheme) -> torch.Tensor:
    """Compact first or second derivative, or filter, of ``f`` along its
    last axis.

    CUDA tensors must be float32 and contiguous and run the kernel; a line
    too short for the scheme, or too long for one block's shared memory,
    and a launch failure raise. CPU tensors take ``lane_derivative_ref``.
    """
    global LAUNCHES
    _native.check_order(scheme)
    if f.device.type == "cpu":
        return lane_derivative_ref(f, dx, scheme)
    out = launch(f, dx, scheme)
    LAUNCHES += 1
    MODE_LAUNCHES["filter" if scheme.derivative_order == 0 else "derivative"] += 1
    return out


def launch(f: torch.Tensor, dx, scheme: CompactScheme, acc: torch.Tensor = None) -> torch.Tensor:
    """One launch of the kernel on a CUDA tensor, ``f' + acc`` with ``acc``
    (``acc`` contiguous, of f's shape), counted by the caller."""
    _native.check_operands("compact_lane", f, *((acc,) if acc is not None else ()))
    if f.ndim == 0:
        raise ValueError("compact_lane needs at least one axis")
    if acc is not None and acc.shape != f.shape:
        raise ValueError(f"acc shape {tuple(acc.shape)} != field shape {tuple(f.shape)}")
    n = f.shape[-1]
    nb = line_nb(n)
    coef, tab, h, win = _chain_launch_tables(scheme, n, nb, float(dx), f.device)
    out = torch.empty_like(f)
    lines = f.numel() // n
    if lines == 0:
        return out
    with torch.cuda.device(f.device):
        err = _native.library().cfd_compact_lane(
            f.data_ptr(),
            out.data_ptr(),
            tab.data_ptr(),
            ctypes.byref(coef),
            acc.data_ptr() if acc is not None else None,
            lines,
            nb,
            h,
            win,
            torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "compact_lane")
    return out
