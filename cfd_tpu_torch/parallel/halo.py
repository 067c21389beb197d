"""Halo exchange between the shards of a distributed field.

The port of ``cfd_tpu/parallel/halo.py``: one ``ppermute`` per direction
(``parallel/mesh.py``) in place of the reference's six-face MPI halo
machinery. A non-periodic line's end shards receive zeros on their open
side, which callers overwrite with physical-boundary data.
"""

from __future__ import annotations

import torch

from .mesh import AXIS_NAMES, Sharded, ppermute

__all__ = ["halo_slices", "exchange_1d", "exchange_3d"]


def halo_slices(x: Sharded, axis_name: str, width: int, periodic: bool, dim: int = 0):
    """Exchange ``width``-deep faces along mesh axis ``axis_name``.

    ``dim`` is the exchange direction in each shard. Returns ``(left,
    right)``: the last ``width`` rows of the left neighbour and the first
    ``width`` rows of the right neighbour along ``dim``. Only the slabs
    move.
    """
    def rows(lo):
        return lambda t: t.narrow(dim, lo if lo >= 0 else t.shape[dim] + lo, width)

    left = ppermute(x.map(rows(-width)), axis_name, 1, periodic)
    right = ppermute(x.map(rows(0)), axis_name, -1, periodic)
    return left, right


def exchange_1d(x: Sharded, axis_name: str, width: int, periodic: bool, dim: int = 0) -> Sharded:
    """Each shard extended with its halos along ``dim``:
    (width + n + width, ...)."""
    left, right = halo_slices(x, axis_name, width, periodic, dim)
    return x.map(lambda c, a, b: torch.cat([a, c, b], dim), left, right)


def exchange_3d(x: Sharded, width: int = 1, periodic=(False, False, False)) -> Sharded:
    """Full six-face halo exchange of blocks ``[..., nz_l, ny_l, nx_l]``:
    each block grown by ``width`` ghost cells on every side of its
    trailing three axes (zeros on open physical edges). Each axis pass
    forwards the halos received in earlier passes, so edge and corner
    ghosts are consistent."""
    for k, (name, per) in enumerate(zip(AXIS_NAMES, periodic)):
        x = exchange_1d(x, name, width, per, dim=k - 3)
    return x
