"""Device meshes, distributed fields and the collectives between shards.

The port of ``cfd_tpu/parallel/mesh.py``. The JAX package is
single-controller: one process drives a ``jax.sharding.Mesh`` of devices,
``shard_map`` runs a per-shard body and ``ppermute``/``all_gather`` move
data between shards. The port is a single process too:

* ``make_mesh(shape, devices=None)`` lays a list of ``torch.device`` out
  as an (npz, npy, npx) mesh. A device may appear more than once:
  ``[cuda:0] * 8`` is a 2x2x2 mesh on one card, ``["cpu"] * 8`` the tests'
  mesh, ``[cuda:0 .. cuda:3]`` a mesh over four cards. ``devices=None``
  takes the visible CUDA devices and raises when there are too few; it
  never falls back to the CPU.
* ``Sharded`` is a distributed field: one tensor per mesh coordinate, each
  on its mesh device, in C order over the mesh. ``map`` runs a per-shard
  body (which may take the shard's coordinate, the counterpart of
  ``lax.axis_index``), and the elementwise operators act shard by shard,
  so a model's RK3 arithmetic is one code for a tensor and a ``Sharded``.
* ``ppermute`` moves a neighbour's slab to each shard with ``.to(device)``
  (a no-op, not a copy, where both shards share a device); ``all_gather``
  concatenates a mesh line's values on each shard's device. Each copy
  between two devices adds to ``ops.dist.PEER_COPIES``. PyTorch orders a
  copy between cards on both cards' current streams, with no wait on the
  host.

``Grid`` is the distributed grid: global shape, spacing, scheme and mesh,
with ``distribute``/``gather`` between a whole field and its shards.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.dist import PEER_COPIES
from ..schemes import SCHEME4, CompactScheme

__all__ = [
    "AXIS_NAMES",
    "Mesh",
    "make_mesh",
    "Sharded",
    "Grid",
    "ppermute",
    "all_gather",
]

AXIS_NAMES = ("z", "y", "x")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (npz, npy, npx) layout of devices; ``devices`` is a numpy object
    array of that shape, as ``jax.sharding.Mesh.devices``."""

    devices: np.ndarray

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return self.devices.size

    def coords(self):
        """Every mesh coordinate, in C order (the order of ``Sharded.shards``)."""
        return list(itertools.product(*map(range, self.shape)))

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]


def make_mesh(shape: Sequence[int], devices: Optional[Sequence] = None) -> Mesh:
    """Build an (npz, npy, npx) mesh with named axes ('z', 'y', 'x').

    ``devices`` (``torch.device`` or strings; repeats allowed) default to
    the visible CUDA devices."""
    shape = tuple(shape)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = math.prod(shape)
    if need > len(devices):
        raise ValueError(f"mesh {shape} needs {need} devices, have {len(devices)}")
    devs = np.empty(need, dtype=object)
    devs[:] = devices[:need]
    return Mesh(devs.reshape(shape))


def _axis(axis) -> int:
    """A mesh axis by name ('z', 'y', 'x') or number."""
    return AXIS_NAMES.index(axis) if isinstance(axis, str) else axis


class Sharded:
    """A value per mesh coordinate: a distributed field's shards, or any
    per-shard intermediate (halo slabs, faces, interface weights).

    ``shards`` are in C order over ``mesh.coords()``, each on its mesh
    device. ``+``, ``-`` and ``*`` with another ``Sharded`` over the same
    mesh, or with a number, act shard by shard (what the models' RK3
    arithmetic uses).
    """

    __slots__ = ("mesh", "shards")

    def __init__(self, mesh: Mesh, shards):
        shards = tuple(shards)
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        self.mesh = mesh
        self.shards = shards

    def __getitem__(self, coord) -> torch.Tensor:
        return self.shards[np.ravel_multi_index(tuple(coord), self.mesh.shape)]

    def map(self, fn: Callable, *others, coords: bool = False) -> "Sharded":
        """``fn(shard, *other_shards)`` (with ``coords``: ``fn(coord, shard,
        *other_shards)``) for every coordinate; ``others`` are ``Sharded``
        over the same mesh."""
        out = []
        for i, coord in enumerate(self.mesh.coords()):
            args = (self.shards[i],) + tuple(o.shards[i] for o in others)
            out.append(fn(coord, *args) if coords else fn(*args))
        return Sharded(self.mesh, out)

    def unzip(self):
        """A ``Sharded`` of k-tuples as k ``Sharded``."""
        return tuple(Sharded(self.mesh, parts) for parts in zip(*self.shards))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(self.shards[0].shape)

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global shape of a field: the shards' trailing three axes
        times the mesh."""
        local = self.local_shape
        return local[:-3] + tuple(n * p for n, p in zip(local[-3:], self.mesh.shape))

    def _binary(self, other, op) -> "Sharded":
        if isinstance(other, Sharded):
            return self.map(op, other)
        return self.map(lambda a: op(a, other))

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._binary(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._binary(other, lambda a, b: b * a)

    def __neg__(self):
        return self.map(lambda a: -a)

    def __repr__(self) -> str:
        return f"Sharded(shape={self.shape}, mesh={self.mesh.shape}, dtype={self.dtype})"


def _moved(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a copy from another device is counted."""
    if t.device != device:
        PEER_COPIES["copies"] += 1
        PEER_COPIES["bytes"] += t.numel() * t.element_size()
    return t.to(device)


def ppermute(x: Sharded, axis, shift: int, periodic: bool) -> Sharded:
    """Each shard receives the value of the shard ``shift`` places before it
    along mesh ``axis`` (wrapping when ``periodic``), moved to its device;
    a shard with no sender on an open line receives zeros."""
    ax = _axis(axis)
    p = x.mesh.shape[ax]
    out = []
    for i, coord in enumerate(x.mesh.coords()):
        src = coord[ax] - shift
        if periodic:
            src %= p
        if 0 <= src < p:
            c = list(coord)
            c[ax] = src
            out.append(_moved(x[c], x.mesh.device(coord)))
        else:
            out.append(torch.zeros_like(x.shards[i]))
    return Sharded(x.mesh, out)


def all_gather(x: Sharded, axis) -> Sharded:
    """Each shard receives the concatenation (along dim 0, in mesh order)
    of the values of every shard on its line along mesh ``axis``, on its
    own device: ``lax.all_gather(..., tiled=True)``."""
    ax = _axis(axis)
    out = []
    for coord in x.mesh.coords():
        dev = x.mesh.device(coord)
        line = []
        for r in range(x.mesh.shape[ax]):
            c = list(coord)
            c[ax] = r
            line.append(_moved(x[c], dev))
        out.append(torch.cat(line))
    return Sharded(x.mesh, out)


@dataclasses.dataclass(frozen=True)
class Grid:
    """A structured 3-D grid distributed over a device mesh.

    Global shape ``(nz, ny, nx)``, spacing ``(dz, dy, dx)``, the scheme
    (periodicity included) and the mesh over which fields are split into
    blocks along z, y and x.
    """

    mesh: Mesh
    shape: Tuple[int, int, int]
    spacing: Tuple[float, float, float]
    scheme: CompactScheme = SCHEME4

    def __post_init__(self):
        for g, m, name in zip(self.shape, self.mesh.shape, AXIS_NAMES):
            if g % m:
                raise ValueError(f"global {name}-extent {g} not divisible by mesh axis {m}")

    @property
    def proc_shape(self) -> Tuple[int, int, int]:
        return tuple(self.mesh.shape)

    @property
    def local_shape(self) -> Tuple[int, int, int]:
        return tuple(g // m for g, m in zip(self.shape, self.proc_shape))

    def _block(self, coord):
        return tuple(slice(c * n, (c + 1) * n) for c, n in zip(coord, self.local_shape))

    def coordinates(self, origin=(0.0, 0.0, 0.0), dtype=torch.float32):
        """The (z, y, x) coordinates as three ``Sharded``: each shard holds
        its block's stretch of that axis, ``i * spacing + origin``."""
        out = []
        for ax, (d, o) in enumerate(zip(self.spacing, origin)):
            shards = []
            for coord in self.mesh.coords():
                n = self.local_shape[ax]
                i = torch.arange(coord[ax] * n, (coord[ax] + 1) * n, dtype=torch.float64)
                shards.append((i * d + o).to(dtype=dtype, device=self.mesh.device(coord)))
            out.append(Sharded(self.mesh, shards))
        return tuple(out)

    def distribute(self, f) -> Sharded:
        """Split a whole field ``[..., nz, ny, nx]`` (tensor or numpy) into
        its blocks, each contiguous on its mesh device."""
        f = torch.as_tensor(f)
        if tuple(f.shape[-3:]) != tuple(self.shape):
            raise ValueError(f"field shape {tuple(f.shape)} != grid {self.shape}")
        return Sharded(self.mesh, [
            f[(Ellipsis,) + self._block(c)].to(self.mesh.device(c)).contiguous()
            for c in self.mesh.coords()
        ])

    def gather(self, f: Sharded) -> np.ndarray:
        """The whole field as a host numpy array."""
        if f.shape[-3:] != tuple(self.shape):
            raise ValueError(f"field shape {f.shape} != grid {self.shape}")
        out = torch.empty(f.shape, dtype=f.dtype)
        for c in self.mesh.coords():
            out[(Ellipsis,) + self._block(c)] = f[c].cpu()
        return out.numpy()
