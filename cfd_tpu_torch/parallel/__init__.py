"""Distributed layer: device meshes, distributed fields, halo exchange and
the distributed compact solves (substructuring and phi/psi), with the
distributed fused RK3 substep."""

from .compact import DirectionTables, DistributedCompactSolver, direction_tables
from .halo import exchange_1d, exchange_3d, halo_slices
from .mesh import AXIS_NAMES, Grid, Mesh, Sharded, all_gather, make_mesh, ppermute

__all__ = [
    "AXIS_NAMES",
    "Grid",
    "Mesh",
    "Sharded",
    "make_mesh",
    "ppermute",
    "all_gather",
    "halo_slices",
    "exchange_1d",
    "exchange_3d",
    "DistributedCompactSolver",
    "DirectionTables",
    "direction_tables",
]
