"""Run configuration: one validated dataclass with ``CFD_*`` overrides.

The port of ``cfd_tpu/config.py``: scheme order and boundary type, dtype,
mesh and grid shape, spacing and the solver's method, with environment
overrides for scripted sweeps. The fields, their defaults, their
validation and ``from_env`` are the JAX package's; ``dtype`` maps to a
torch dtype, ``method`` takes the port's distributed routes
(``parallel.compact.METHODS``: ``"kernel"`` where the JAX package says
``"pallas"``), and ``make_grid`` lays the mesh over a list of devices.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch

from .parallel.compact import METHODS
from .schemes import CompactScheme, get_scheme

__all__ = ["Config"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class Config:
    """End-to-end run configuration."""

    order: int = 4
    periodic: bool = False
    dtype: str = "float32"  # 'float32' | 'bfloat16' | 'float64'
    method: str = "auto"  # parallel.compact.METHODS
    mesh_shape: Tuple[int, int, int] = (1, 1, 1)
    grid_shape: Tuple[int, int, int] = (256, 256, 256)
    spacing: Tuple[float, float, float] = (1e-2, 1e-2, 1e-2)

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"bad dtype {self.dtype}")
        if self.method not in METHODS:
            raise ValueError(f"bad method {self.method}")
        if self.dtype == "float64" and self.method == "kernel":
            raise ValueError("float64 requires method 'pcr' or 'thomas'")
        self.scheme  # validates order/periodic

    @property
    def scheme(self) -> CompactScheme:
        return get_scheme(self.order, self.periodic)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def from_env(cls, prefix: str = "CFD_", **overrides) -> "Config":
        """Build from CFD_* environment variables plus explicit overrides."""

        def get(name, cast, default):
            raw = os.environ.get(prefix + name)
            return cast(raw) if raw is not None else default

        def triple(raw):
            z, y, x = (int(v) for v in raw.split(","))
            return (z, y, x)

        def ftriple(raw):
            parts = [float(v) for v in raw.split(",")]
            if len(parts) == 1:  # CFD_SPACING=0.01 means isotropic
                parts = parts * 3
            dz, dy, dx = parts
            return (dz, dy, dx)

        base = dict(
            order=get("ORDER", int, cls.order),
            periodic=get("PERIODIC", lambda s: s.lower() in ("1", "true"), cls.periodic),
            dtype=get("DTYPE", str, cls.dtype),
            method=get("METHOD", str, cls.method),
            mesh_shape=get("MESH", triple, cls.mesh_shape),
            grid_shape=get("GRID", triple, cls.grid_shape),
            spacing=get("SPACING", ftriple, cls.spacing),
        )
        base.update(overrides)
        return cls(**base)

    def make_grid(self, devices: Optional[Sequence] = None):
        """The distributed grid over ``parallel.make_mesh(mesh_shape,
        devices)``: ``devices`` default to the visible CUDA devices, and may
        repeat (``[cuda:0] * 8`` lays a (2, 2, 2) mesh on one card)."""
        from .parallel import Grid, make_mesh

        mesh = make_mesh(self.mesh_shape, devices)
        return Grid(mesh, self.grid_shape, self.spacing, self.scheme)
