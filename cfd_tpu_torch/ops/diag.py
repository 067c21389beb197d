"""The diagnosis kernels of the benchmark harness: K14 and K15.

The port of the Pallas kernels of the JAX package's benchmark folder,
which time access patterns and stripped kernel stages on their own:

* ``copy2d`` (``benchmarks/diag_lane.py`` ``copy2d``) copies a (B, n)
  array over (rows, cols) tiles, and ``copy3d`` (``copy3d``) a (nz, ny,
  nx) array over (bz, by, nx) slabs: K14 ``diag_copy``
  (``csrc/diag_copy.cu``). The output is bitwise the input; what differs
  between cases is the access pattern.
* ``dfdz_stage`` (``benchmarks/diag_dfdz.py`` ``_pallas2d`` with its bodies
  ``k_copy``, ``k_rolls``, ``k_dots``, ``k_dots_default``) runs one stage
  of the dfdz kernel on the (nz, L) layout in C-column tiles: K15
  ``diag_dfdz`` (``csrc/diag_dfdz.cu``).

On a CUDA float32 tensor each launches its kernel, or raises; on a CPU
tensor it returns its plain version (``*_ref``). ``COPY_LAUNCHES`` counts
K14's launches by form (``"2d"``, ``"3d"``), ``DFDZ_LAUNCHES`` K15's by
mode; nothing but a launch adds to them.
"""

from __future__ import annotations

import functools

import torch

from ..parallel.compact import direction_tables
from ..schemes import SCHEME4_PERIODIC
from . import _native

__all__ = [
    "COPY_LAUNCHES",
    "DFDZ_LAUNCHES",
    "MODES",
    "BLOCK",
    "copy2d",
    "copy2d_ref",
    "copy3d",
    "copy3d_ref",
    "dfdz_stage",
    "dfdz_stage_ref",
    "dfdz_table",
]

COPY_LAUNCHES = {"2d": 0, "3d": 0}
MODES = ("copy", "rolls", "dots", "dots_default")
DFDZ_LAUNCHES = {mode: 0 for mode in MODES}
BLOCK = 128  # rows of a diagonal block of the dots stages (diag_dfdz.py's M)
_ALIGN = 16  # bytes: the kernels move 16 bytes a thread


def _tiles(shape, tile, what: str) -> None:
    for extent, size in zip(shape, tile):
        if size < 1 or extent % size:
            raise ValueError(f"{what}: tiles {tuple(tile)} do not divide shape {tuple(shape)}")


def copy2d_ref(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The plain version of ``copy2d``: a copy of ``x``."""
    _check_copy2d(x, rows, cols)
    return x.clone()


def copy3d_ref(x: torch.Tensor, bz: int, by: int) -> torch.Tensor:
    """The plain version of ``copy3d``: a copy of ``x``."""
    _check_copy3d(x, bz, by)
    return x.clone()


def _check_copy2d(x, rows, cols):
    if x.ndim != 2:
        raise ValueError(f"copy2d takes a (B, n) array, got shape {tuple(x.shape)}")
    _tiles(x.shape, (rows, cols), "copy2d")


def _check_copy3d(x, bz, by):
    if x.ndim != 3:
        raise ValueError(f"copy3d takes a (nz, ny, nx) array, got shape {tuple(x.shape)}")
    _tiles(x.shape[:2], (bz, by), "copy3d")


def copy2d(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Copy a (B, n) array over (rows, cols) tiles: ``rows`` runs of
    ``cols`` floats, ``n`` apart, per tile. K14 on CUDA float32; the plain
    version on a CPU tensor."""
    _check_copy2d(x, rows, cols)
    if x.device.type == "cpu":
        return copy2d_ref(x, rows, cols)
    B, n = x.shape
    out = _copy_launch(x, B // rows, n // cols, rows * n, cols, rows, cols, n)
    COPY_LAUNCHES["2d"] += 1
    return out


def copy3d(x: torch.Tensor, bz: int, by: int) -> torch.Tensor:
    """Copy a (nz, ny, nx) array over (bz, by, nx) slabs: ``bz`` runs of
    ``by * nx`` floats, ``ny * nx`` apart, per slab. K14 on CUDA float32;
    the plain version on a CPU tensor."""
    _check_copy3d(x, bz, by)
    if x.device.type == "cpu":
        return copy3d_ref(x, bz, by)
    nz, ny, nx = x.shape
    out = _copy_launch(x, nz // bz, ny // by, bz * ny * nx, by * nx, bz, by * nx, ny * nx)
    COPY_LAUNCHES["3d"] += 1
    return out


def _copy_launch(x, tiles_i, tiles_j, stride_i, stride_j, runs, run, stride) -> torch.Tensor:
    _native.check_operands("diag_copy", x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _native.library().cfd_diag_copy(
            x.data_ptr(), out.data_ptr(), tiles_i, tiles_j, stride_i, stride_j, runs, run,
            stride, torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "diag_copy")
    return out


@functools.lru_cache(maxsize=16)
def dfdz_table(nz: int, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dots stages' blocks T (nz // 128, 128, 128): the dense inverses
    of the 128-point diagonal blocks of SCHEME4_PERIODIC's LHS on a line
    of ``nz`` points (``parallel.compact.direction_tables(...).tinv``,
    float64, rounded once to ``dtype``), on ``device``."""
    if nz % BLOCK:
        raise ValueError(f"the dots stages take nz % {BLOCK} == 0, got nz = {nz}")
    tinv = direction_tables(SCHEME4_PERIODIC, nz, nz // BLOCK).tinv
    return torch.as_tensor(tinv, dtype=dtype, device=device)


def _check_dfdz(x, mode, cols, table):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if x.ndim != 2:
        raise ValueError(f"dfdz_stage takes an (nz, L) array, got shape {tuple(x.shape)}")
    nz, L = x.shape
    if cols < 1 or L % cols:
        raise ValueError(f"dfdz_stage: {cols}-column tiles do not divide L = {L}")
    if mode in ("dots", "dots_default"):
        if nz % BLOCK:
            raise ValueError(f"dfdz_stage {mode} takes nz % {BLOCK} == 0, got nz = {nz}")
        want = (nz // BLOCK, BLOCK, BLOCK)
        if table is not None and tuple(table.shape) != want:
            raise ValueError(f"dfdz_stage: table shape {tuple(table.shape)} != {want}")


def dfdz_stage_ref(x: torch.Tensor, mode: str, cols: int, table: torch.Tensor = None):
    """The plain version of ``dfdz_stage``, in ``x``'s dtype (dots_default:
    T and x rounded to bfloat16, multiplied in float32)."""
    _check_dfdz(x, mode, cols, table)
    if mode == "copy":
        return x.clone()
    if mode == "rolls":
        g = torch.roll(x, -1, 0) - x
        return g + torch.roll(g, 1, 0)
    if table is None:
        table = dfdz_table(x.shape[0], x.device)
    nb = x.shape[0] // BLOCK
    blocks = x.reshape(nb, BLOCK, -1)
    if mode == "dots":
        return torch.matmul(table.to(x.dtype), blocks).reshape(x.shape)
    round16 = lambda t: t.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(round16(table), round16(blocks)).reshape(x.shape)


def dfdz_stage(x: torch.Tensor, mode: str, cols: int, table: torch.Tensor = None):
    """One stage of the dfdz kernel on ``x`` (nz, L) in ``cols``-column
    tiles: ``"copy"`` (out = x), ``"rolls"`` (the RHS stage, cyclic along
    the leading axis: g = x[i+1] - x[i], out = g[i] + g[i-1]), ``"dots"``
    (out[128 b : 128 b + 128] = T[b] @ x[128 b : 128 b + 128], float32) and
    ``"dots_default"`` (the same with bf16 operands, float32 sums). ``table``
    is T, (nz // 128, 128, 128); None takes ``dfdz_table(nz, x.device)``.

    K15 on CUDA float32 (``cols % 64 == 0``, 16-byte aligned tensors); the
    plain version on a CPU tensor.
    """
    _check_dfdz(x, mode, cols, table)
    if x.device.type == "cpu":
        return dfdz_stage_ref(x, mode, cols, table)
    dots = mode in ("dots", "dots_default")
    if dots and table is None:
        table = dfdz_table(x.shape[0], x.device)
    operands = (x, table) if dots else (x,)
    _native.check_operands("diag_dfdz", *operands)
    if cols % 64:
        raise ValueError(f"diag_dfdz takes tiles of a multiple of 64 columns, got {cols}")
    out = torch.empty_like(x)
    if any(t.data_ptr() % _ALIGN for t in operands + (out,)):
        raise ValueError("diag_dfdz takes 16-byte aligned tensors")
    nz, L = x.shape
    with torch.cuda.device(x.device):
        err = _native.library().cfd_diag_dfdz(
            x.data_ptr(), out.data_ptr(), table.data_ptr() if dots else None,
            MODES.index(mode), nz, L, cols, torch.cuda.current_stream().cuda_stream,
        )
    _native.check(err, "diag_dfdz")
    DFDZ_LAUNCHES[mode] += 1
    return out
